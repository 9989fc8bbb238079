"""The SLO-driven cross-tenant arbiter (docs/SERVING.md).

One control loop per :class:`~windflow_tpu_torch.serving.server.Server`,
riding the same ~1 Hz cadence as the diagnosis tick: every interval it
*reads* each tenant's already-computed SLO tracker state (burn rates,
open breach, violating objectives -- slo/plane.py judges them on the
diagnosis tick) and bottleneck scores, and only under contention does
it *actuate* -- scale a donor tenant's elastic operator down and/or
move part of the donor's credit allocation to the breaching victim.
It adds zero hot-path work: everything it reads is a gauge some other
plane already maintains, and when nothing is breached it takes no
action at all (bench ``14_multitenant_contention`` asserts results
with the arbiter on are bitwise identical to off when uncontended).

Policy (:func:`plan_arbitration`, pure and unit-tested):

* a **victim** is a RUNNING tenant whose declared SLO is in an open
  breach episode, sustained ``breach_ticks`` consecutive arbiter ticks
  on top of the tracker's own debounce (the anomaly-band hysteresis
  discipline -- one tracker blip never triggers an arbitration);
* a **donor** is a RUNNING, non-breached, ``donor=True`` tenant of
  priority <= the victim's (never squeeze a more-important tenant for
  a less-important one), outside its per-donor cooldown, with
  something left to give: an elastic operator above ``min_replicas``
  or credits above its ``min_credits`` floor;
* victims are served worst-first (highest priority, then weight);
  donors are squeezed cheapest-first (lowest priority, then weight);
* one decision per tick (gentle convergence), each opening a per-donor
  ``cooldown_s`` window;
* every decision is recorded as an ``arbitration`` flight event
  carrying ``{victim, donor, action, evidence}`` in the server ring
  AND both tenants' graph rings, so ``doctor`` on either side explains
  it;
* **restitution**: once a victim's episode closes and stays closed
  ``clear_ticks`` consecutive ticks, the donations it drove are
  reversed newest-first (donor scaled back up, credits returned), each
  reversal an ``arbitration`` event with ``action: restore ...``.
"""
from __future__ import annotations

import threading
import time as _time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .tenant import TenantState


@dataclass
class ArbiterConfig:
    """Server-level arbiter tuning (``Server(arbiter=...)``)."""

    enabled: bool = True
    # decision cadence; matches the diagnosis tick it reads from
    interval_s: float = 1.0
    # victim must be breached this many CONSECUTIVE arbiter ticks
    # (on top of the SLO tracker's own 2-tick debounce)
    breach_ticks: int = 2
    # victim must be clear this many consecutive ticks before its
    # donations are returned (hysteresis against flapping)
    clear_ticks: int = 3
    # no further squeeze of the same donor for this long after one
    cooldown_s: float = 5.0
    # fraction of the donor's spare credits (above its floor) moved
    # per credit action
    credit_step_frac: float = 0.5
    # drain budget handed to PipeGraph.rescale per action
    rescale_timeout_s: float = 60.0


@dataclass
class TenantView:
    """One tenant's arbitration-relevant state at a tick -- a pure
    value so the planner is testable without a server."""

    name: str
    running: bool = True
    priority: int = 0
    weight: float = 1.0
    donor: bool = True
    # SLO tracker state (None when the tenant declared no objectives)
    breached: Optional[bool] = None
    burn_fast: float = 0.0
    budget_burned: float = 0.0
    violating: Tuple[str, ...] = ()
    values: dict = field(default_factory=dict)
    # actuation surface
    credits: int = 0
    min_credits: int = 1
    # (operator_key, parallelism, min_replicas, max_replicas)
    elastic: List[Tuple[str, int, int, int]] = field(default_factory=list)
    # diagnosis root-cause walk: the donor's own bottleneck score
    # (recorded as evidence -- a donor that is itself saturated gets
    # named in the decision, helping post-mortems)
    bottleneck: float = 0.0
    # device-lease rows from the worker's DeviceLeaseRegistry
    # ({"Operator", "Chip", "Contended", "Resident", …}); empty when
    # the server schedules no device lanes
    device_ops: List[dict] = field(default_factory=list)
    # the live TenantHandle this view was taken from (ignored by the
    # pure planners; the arbiter actuates through it so an evict +
    # same-name resubmit after the snapshot can never be squeezed as
    # if it were the tenant the view described)
    handle: object = field(default=None, compare=False)


@dataclass
class Donation:
    """Ledger entry for one applied squeeze, so restitution can
    reverse it exactly.  ``victim_departed`` marks entries whose
    victim name was evicted and RE-SUBMITTED as an unrelated tenant:
    the new namesake must neither hold the restitution hostage nor
    be debited for credits it never received."""

    victim: str
    donor: str
    operator: Optional[str] = None
    old_parallelism: int = 0
    new_parallelism: int = 0
    credits_moved: int = 0
    victim_departed: bool = False


def _spare_credits(v: TenantView, frac: float) -> int:
    """The documented step: ``frac`` of the credits above the donor's
    floor (min 1 so a tiny spare still converges), never more than the
    spare itself."""
    spare = max(0, v.credits - v.min_credits)
    if spare <= 0:
        return 0
    return max(1, min(spare, int(spare * frac)))


def _scalable_op(v: TenantView) -> Optional[Tuple[str, int, int]]:
    """(operator, parallelism, new_parallelism) of the donor operator
    with the most headroom above its floor, or None."""
    best = None
    for op, par, lo, _hi in v.elastic:
        if par > lo and (best is None or par - lo > best[1] - best[2]):
            best = (op, par, lo)
    if best is None:
        return None
    op, par, lo = best
    new = max(lo, par - max(1, par // 2))
    return op, par, new


def _contended_demotion(victim: TenantView,
                        donor: TenantView) -> Optional[dict]:
    """The device rung of the escalation ladder: when the victim holds
    a lease on a CONTENDED chip and the donor holds a demotable
    (non-resident) lease on the same chip, flipping the donor's lane
    device->host frees the chip for the breaching tenant -- the
    targeted fix, tried before any rescale/credit squeeze."""
    victim_chips = {r.get("Chip") for r in victim.device_ops
                    if r.get("Contended")}
    if not victim_chips:
        return None
    for r in donor.device_ops:
        if r.get("Chip") in victim_chips and not r.get("Resident"):
            return {"type": "device", "operator": r["Operator"],
                    "chip": r.get("Chip"), "to": "host"}
    return None


def plan_arbitration(views: List[TenantView], cfg: ArbiterConfig,
                     breach_runs: Dict[str, int],
                     cooldowns: Dict[str, float],
                     now: float) -> Optional[dict]:
    """One decision (or None): the worst sustained victim paired with
    the cheapest eligible donor, with the concrete actions to apply.
    Pure -- all runtime state comes in as arguments."""
    victims = [v for v in views
               if v.running and v.breached
               and breach_runs.get(v.name, 0) >= cfg.breach_ticks]
    if not victims:
        return None
    victims.sort(key=lambda v: (-v.priority, -v.weight, v.name))
    for victim in victims:
        donors = [d for d in views
                  if d.running and d.donor and d.name != victim.name
                  and not d.breached
                  and d.priority <= victim.priority
                  and now >= cooldowns.get(d.name, 0.0)]
        donors.sort(key=lambda d: (d.priority, d.weight, d.name))
        # rung 1 of the ladder: a chip-targeted device demotion.  When
        # the victim's chip is contended, squeezing an unrelated
        # donor's credits cannot clear the contention -- sweep for a
        # co-lessee first (cheapest donor order still applies).
        for donor in donors:
            demote = _contended_demotion(victim, donor)
            if demote is None:
                continue
            return {
                "victim": victim.name,
                "donor": donor.name,
                "actions": [demote],
                "evidence": {
                    "violating": list(victim.violating),
                    "burn_fast": victim.burn_fast,
                    "budget_burned": victim.budget_burned,
                    "values": dict(victim.values),
                    "victim_priority": victim.priority,
                    "donor_priority": donor.priority,
                    "donor_weight": donor.weight,
                    "donor_bottleneck": round(donor.bottleneck, 3),
                    "chip": demote["chip"],
                    "contended": True,
                },
            }
        # rungs 2+3: elastic down-scale, then credit transfer
        for donor in donors:
            actions = []
            rescale = _scalable_op(donor)
            if rescale is not None:
                op, par, new = rescale
                actions.append({"type": "rescale", "operator": op,
                                "old": par, "new": new})
            moved = _spare_credits(donor, cfg.credit_step_frac)
            if moved > 0:
                actions.append({"type": "credits", "moved": moved,
                                "donor_credits": donor.credits,
                                "victim_credits": victim.credits})
            if not actions:
                continue  # this donor has nothing left; try the next
            return {
                "victim": victim.name,
                "donor": donor.name,
                "actions": actions,
                "evidence": {
                    "violating": list(victim.violating),
                    "burn_fast": victim.burn_fast,
                    "budget_burned": victim.budget_burned,
                    "values": dict(victim.values),
                    "victim_priority": victim.priority,
                    "donor_priority": donor.priority,
                    "donor_weight": donor.weight,
                    "donor_bottleneck": round(donor.bottleneck, 3),
                },
            }
    return None


def plan_restitution(views: List[TenantView], cfg: ArbiterConfig,
                     donations: List[Donation],
                     clear_runs: Dict[str, int]) -> Optional[Donation]:
    """The newest donation whose victim has stayed clear (un-breached,
    still running) for ``clear_ticks`` consecutive ticks -- or whose
    victim is gone entirely (no point holding a squeeze for a tenant
    that ended).  Returned one at a time, newest-first, mirroring the
    gentle one-action-per-tick application."""
    by_name = {v.name: v for v in views}
    for d in reversed(donations):
        v = None if d.victim_departed else by_name.get(d.victim)
        if v is None or not v.running:
            return d
        if not v.breached and clear_runs.get(d.victim, 0) \
                >= cfg.clear_ticks:
            return d
    return None


def describe_actions(actions: List[dict], donor: str,
                     victim: str, restore: bool = False) -> str:
    """Human phrasing of a decision's actions -- the ``action`` string
    in the flight event and the doctor line."""
    parts = []
    for a in actions:
        if a["type"] == "rescale":
            arrow = f"{a['old']}→{a['new']}"
            verb = "restored" if restore else "scaled"
            parts.append(f"{verb} {a['operator']}@{donor} {arrow}")
        elif a["type"] == "credits":
            if restore:
                parts.append(f"returned {a['moved']} credits to {donor}")
            else:
                parts.append(f"granted {a['moved']} credits to {victim}")
        elif a["type"] == "device":
            parts.append(f"demoted {a['operator']}@{donor} "
                         f"device→host on contended {a['chip']}")
    return ", ".join(parts) if parts else "no-op"


def describe_evidence(ev: dict) -> str:
    """One evidence phrase for the doctor line, e.g.
    ``throughput 12.0 < floor rps, budget 45% burned``."""
    if not ev:
        return ""
    parts = []
    vals = ev.get("values") or {}
    for name in ev.get("violating") or ():
        if name == "e2e_p99" and vals.get("e2e_p99_ms") is not None:
            parts.append(f"p99 {vals['e2e_p99_ms']:g} ms over budget")
        elif name == "throughput" \
                and vals.get("throughput_rps") is not None:
            parts.append(
                f"throughput {vals['throughput_rps']:g} rps under floor")
        elif name == "frontier_lag" \
                and vals.get("frontier_lag_ms") is not None:
            parts.append(
                f"frontier lag {vals['frontier_lag_ms']:g} ms over cap")
        else:
            parts.append(name)
    if ev.get("budget_burned"):
        parts.append(f"{ev['budget_burned'] * 100:.0f}% budget burned")
    return ", ".join(parts)


class CrossTenantArbiter(threading.Thread):
    """Owns the cadence and the hysteresis/cooldown state; reads
    tenant views from the server and applies planned decisions through
    it.  ``tick()`` is callable directly (tests drive it without the
    thread)."""

    def __init__(self, server, cfg: Optional[ArbiterConfig] = None):
        super().__init__(name="windflow-tenant-arbiter", daemon=True)
        self.server = server
        self.cfg = cfg or ArbiterConfig()
        self._stop_evt = threading.Event()
        # orders tick() (arbiter thread) against forget() (a submit
        # thread re-using a tenant name): ledger/hysteresis mutations
        # only -- never held across an apply (rescales drain for
        # seconds)
        self._state_lock = threading.Lock()
        self._breach_runs: Dict[str, int] = {}
        self._clear_runs: Dict[str, int] = {}
        self._cooldowns: Dict[str, float] = {}
        self.donations: List[Donation] = []
        # recent applied decisions, BOUNDED like every other
        # observability ring in this repo; decisions_total keeps the
        # lifetime count for the stats surface
        self.decisions: deque = deque(maxlen=256)
        self.decisions_total = 0

    # -- cadence -------------------------------------------------------
    def run(self) -> None:
        while not self._stop_evt.wait(self.cfg.interval_s):
            try:
                self.tick()
            except Exception:  # pragma: no cover -- the arbiter must
                import traceback  # never take the server down
                traceback.print_exc()

    def stop(self) -> None:
        self._stop_evt.set()
        if self.is_alive():
            self.join(timeout=10.0)

    def forget(self, name: str) -> None:
        """Drop all hysteresis state for ``name`` -- called by the
        server when a tenant name is (re)submitted, so a fresh tenant
        can never inherit a departed namesake's breach run or
        cooldown (eviction + resubmit inside one tick would otherwise
        dodge the absent-name sweep in ``_advance_runs``).  The
        donation ledger is scrubbed too: a departed DONOR's squeezes
        die with it (the new namesake never donated and must not be
        'restored'), and entries owed by a departed VICTIM are marked
        so restitution fires instead of resolving against the new
        namesake's lease."""
        with self._state_lock:
            self._breach_runs.pop(name, None)
            self._clear_runs.pop(name, None)
            self._cooldowns.pop(name, None)
            self.donations = [d for d in self.donations
                              if d.donor != name]
            for d in self.donations:
                if d.victim == name:
                    d.victim_departed = True

    # -- one decision cycle --------------------------------------------
    def _advance_runs(self, views: List[TenantView]) -> None:
        seen = set()
        for v in views:
            seen.add(v.name)
            if v.breached:
                self._breach_runs[v.name] = \
                    self._breach_runs.get(v.name, 0) + 1
                self._clear_runs[v.name] = 0
            else:
                self._breach_runs[v.name] = 0
                self._clear_runs[v.name] = \
                    self._clear_runs.get(v.name, 0) + 1
        for name in list(self._breach_runs):
            if name not in seen:
                self._breach_runs.pop(name, None)
                self._clear_runs.pop(name, None)
        for name in list(self._cooldowns):
            # prune with the same sweep: a long-lived server cycling
            # tenant names must not grow this dict without bound, and
            # a re-submitted name must not inherit a departed
            # namesake's residual cooldown
            if name not in seen:
                self._cooldowns.pop(name, None)

    def tick(self, now: Optional[float] = None) -> Optional[dict]:
        now = _time.monotonic() if now is None else now
        views = self.server.tenant_views()
        with self._state_lock:
            self._advance_runs(views)
            decision = plan_arbitration(views, self.cfg,
                                        self._breach_runs,
                                        self._cooldowns, now)
        if decision is not None:
            by_name = {v.name: v for v in views}
            donor_view = by_name.get(decision["donor"])
            donor_handle = donor_view.handle \
                if donor_view is not None else None
            victim_view = by_name.get(decision["victim"])
            applied = self.server.apply_arbitration(
                decision,
                victim=victim_view.handle
                if victim_view is not None else None,
                donor=donor_handle)
            if applied:
                with self._state_lock:
                    # a forget() during the (possibly seconds-long)
                    # apply means the donor name now belongs to an
                    # unrelated tenant: no cooldown, no ledger entry
                    # -- the squeeze died with the evicted graph
                    same = donor_handle is None or \
                        self.server.get(decision["donor"]) \
                        is donor_handle
                    if same:
                        self._cooldowns[decision["donor"]] = \
                            now + self.cfg.cooldown_s
                        for a in decision["actions"]:
                            if a.get("applied") is False:
                                continue
                            if a["type"] == "device":
                                # device demotions are ONE-WAY: a
                                # restitution that promoted the lane
                                # back host->device would re-contend
                                # the chip the moment the victim
                                # recovers (flap by construction).
                                # Re-promotion is an operator decision
                                # via replace_lane(op, "device").
                                continue
                            self.donations.append(Donation(
                                victim=decision["victim"],
                                donor=decision["donor"],
                                operator=a.get("operator")
                                if a["type"] == "rescale" else None,
                                old_parallelism=a.get("old", 0),
                                new_parallelism=a.get("new", 0),
                                credits_moved=a.get("moved", 0)
                                if a["type"] == "credits" else 0))
                self.decisions.append(decision)
                self.decisions_total += 1
            return decision
        # nothing to squeeze: consider giving something back.  A
        # ledger entry is dropped only once FULLY restored (the apply
        # mutates it down -- a partial give-back keeps its remainder)
        # or once its donor is gone (nothing left to restore to); a
        # failed restore (e.g. a rescale drain timeout, no cap room)
        # stays ledgered and is skipped over THIS tick so one stuck
        # entry cannot starve an older restorable donation forever.
        # At most one actuation per tick, like the squeeze path.
        skipped: set = set()
        while True:
            with self._state_lock:
                pool = [x for x in self.donations
                        if id(x) not in skipped]
            d = plan_restitution(views, self.cfg, pool,
                                 self._clear_runs)
            if d is None:
                return None
            with self._state_lock:
                # forget() may have scrubbed it between the snapshot
                # and now (tenant name re-submitted): applying would
                # resolve against an unrelated namesake
                if not any(x is d for x in self.donations):
                    skipped.add(id(d))
                    continue
            applied = self.server.apply_restitution(d)
            donor = self.server.get(d.donor)
            fully = d.operator is None and d.credits_moved <= 0
            if fully or donor is None \
                    or donor.state != TenantState.RUNNING:
                with self._state_lock:
                    self.donations = [x for x in self.donations
                                      if x is not d]
            if applied:
                return None
            skipped.add(id(d))
