"""The tiered keyed store (docs/RESILIENCE.md "Tiered state & memory
pressure").

Drop-in replacement for the plain dict a keyed logic keeps per-key
state in (``AccumulatorLogic.state``), adopted at graph start through
the logic's ``enable_tiered_state`` hook.  Three tiers under one
dict-like surface::

    hot   live Python objects, LRU-ordered   (device forests keep
          their own residency -- they report tier "device")
    warm  pickled bytes in host RAM, demotion-ordered
    cold  pickled bytes in disk segments (state/spill.py)

Reads promote (cold/warm → hot); ``maintain()`` -- called every
``maintain_every`` store operations on the replica's own thread --
walks the :class:`~windflow_tpu_torch.state.budget.StateBudget` ladder:
demote LRU hot keys, spill the oldest warm keys in batches, and past
the hard budget SHED the coldest keys into ``dead_letters`` with a
``state_pressure`` flight event (a shed key restarts from the
operator's init value on its next appearance -- degraded and loud,
never an allocator crash).  Keys the audit plane's hot-key sketch
currently names (bound via ``bind_hot_sketch``) are pinned hot.

Composition with the other planes:

* delta snapshots: ``keyed_state_pickled()`` serves warm/cold keys
  from their STORED pickled bytes, so an unchanged cold key digests
  identically every epoch and the chain references it with zero new
  blob bytes (the "cold tier by reference" property);
* restore/rescale/supervision: every restore funnels through
  ``replace_all``, which wipes all tiers (spill dir included) before
  loading -- the disk working set never survives a restore;
* census: ``census()`` returns per-tier key/byte counts and the
  spill/promotion/shed counters as a third gauge element.

Spill-write failures (ENOSPC) degrade: a ``spill_abort`` flight event,
the batch stays warm, and spilling backs off for a few maintenance
rounds while demotion/shed keep enforcing the ceiling.
"""
from __future__ import annotations

import pickle
import sys
from collections import OrderedDict
from typing import Any, Dict, Iterable, Optional

# per-key bookkeeping overhead added to getsizeof (dict slot, control
# fields, fragmentation) -- gauge-grade, same spirit as the census
_KEY_OVERHEAD = 96
_MISSING = object()
# maintenance rounds to skip spilling after a failed segment write
_SPILL_COOLDOWN = 8


def _size_of(value) -> int:
    try:
        return sys.getsizeof(value) + _KEY_OVERHEAD
    except TypeError:
        return 2 * _KEY_OVERHEAD


class TieredKeyedStore:
    """Single-writer (the owning replica thread); the auditor reads
    ``census()``/``tier_of()`` as lock-free gauges."""

    def __init__(self, budget, spill, node: str = "?", flight=None,
                 dead_letters=None, hot_max_keys: Optional[int] = None,
                 maintain_every: int = 64, spill_batch: int = 256):
        self.budget = budget
        self.spill = spill
        self.node = node
        self.flight = flight
        self.dead_letters = dead_letters
        self.hot_max_keys = hot_max_keys
        self.maintain_every = max(1, int(maintain_every))
        self.spill_batch = max(1, int(spill_batch))
        self.hot_keys_fn = None          # audit sketch (bind_hot_sketch)
        # the most recently accessed key is pinned until the next
        # access: the caller (AccumulatorLogic.svc) mutates the
        # returned value IN PLACE after get()/[]= returns, so demoting
        # (pickling) it inside the same call would strand the mutation
        # on a dead object
        self._mru: Any = _MISSING
        self._hot: Dict[Any, Any] = {}   # insertion order == LRU order
        self._warm: "OrderedDict[Any, bytes]" = OrderedDict()
        self._hot_sizes: Dict[Any, int] = {}
        self._hot_bytes = 0
        self._warm_bytes = 0
        self._ops = 0
        self._cooldown = 0
        self.promotions = 0
        self.demotions = 0
        self.spilled_keys = 0
        self.sheds = 0

    # -- dict surface (what AccumulatorLogic.svc touches) --------------
    def get(self, key, default=None):
        hot = self._hot
        v = hot.get(key, _MISSING)
        if v is not _MISSING:
            hot[key] = hot.pop(key)          # LRU touch
            self._mru = key
            self._tick()
            return v
        vb = self._warm.pop(key, None)
        if vb is not None:
            self._warm_bytes -= len(vb)
            return self._admit(key, pickle.loads(vb), promoted=True)
        if key in self.spill:
            vb = self.spill.get(key)
            self.spill.discard(key)
            return self._admit(key, pickle.loads(vb), promoted=True)
        self._tick()
        return default

    def __getitem__(self, key):
        v = self.get(key, _MISSING)
        if v is _MISSING:
            raise KeyError(key)
        return v

    def __setitem__(self, key, value) -> None:
        vb = self._warm.pop(key, None)
        if vb is not None:
            self._warm_bytes -= len(vb)
        elif key in self.spill:
            self.spill.discard(key)
        self._admit(key, value)

    def __delitem__(self, key) -> None:
        if self._drop(key) is _MISSING:
            raise KeyError(key)

    def pop(self, key, default=_MISSING):
        got = self._drop(key)
        if got is _MISSING:
            if default is _MISSING:
                raise KeyError(key)
            return default
        return got

    def __contains__(self, key) -> bool:
        return (key in self._hot or key in self._warm
                or key in self.spill)

    def __len__(self) -> int:
        return len(self._hot) + len(self._warm) + len(self.spill)

    def __bool__(self) -> bool:
        return len(self) > 0

    def keys(self):
        yield from self._hot
        yield from self._warm
        yield from self.spill.keys()

    __iter__ = keys

    def items(self):
        yield from self._hot.items()
        for k, vb in list(self._warm.items()):
            yield k, pickle.loads(vb)
        for k, vb in self.spill.items_pickled():
            yield k, pickle.loads(vb)

    def values(self):
        for _k, v in self.items():
            yield v

    # -- internal admission/removal ------------------------------------
    def _admit(self, key, value, promoted: bool = False):
        hot, sizes = self._hot, self._hot_sizes
        old = sizes.get(key)
        if old is not None:
            self._hot_bytes -= old
            hot.pop(key, None)
        sz = _size_of(value)
        hot[key] = value
        sizes[key] = sz
        self._hot_bytes += sz
        self._mru = key
        if promoted:
            self.promotions += 1
        self._tick()
        return value

    def _drop(self, key):
        if key == self._mru:
            self._mru = _MISSING
        v = self._hot.pop(key, _MISSING)
        if v is not _MISSING:
            self._hot_bytes -= self._hot_sizes.pop(key, 0)
            return v
        vb = self._warm.pop(key, None)
        if vb is not None:
            self._warm_bytes -= len(vb)
            return pickle.loads(vb)
        if key in self.spill:
            vb = self.spill.get(key)
            self.spill.discard(key)
            return pickle.loads(vb)
        return _MISSING

    def _tick(self) -> None:
        self._ops += 1
        if self._ops % self.maintain_every == 0:
            self.maintain()

    # -- budget enforcement --------------------------------------------
    def mem_bytes(self) -> int:
        return self._hot_bytes + self._warm_bytes

    def _pinned(self) -> frozenset:
        fn = self.hot_keys_fn
        if fn is None:
            return frozenset()
        try:
            got = fn()
        except Exception:
            return frozenset()
        return frozenset(got or ())

    def maintain(self) -> None:
        """Enforce the budget ladder; replica-thread only."""
        budget = self.budget
        band = budget.pressure(self.mem_bytes())
        over_keys = (self.hot_max_keys is not None
                     and len(self._hot) > self.hot_max_keys)
        if band == "ok" and not over_keys:
            return
        pinned = self._pinned()
        if self._mru is not _MISSING:
            pinned = pinned | {self._mru}
        self._demote(budget.demote_at, pinned)
        if self.budget.pressure(self.mem_bytes()) in ("spill", "shed") \
                or self._warm_bytes > budget.spill_at:
            self._spill_warm(budget)
        if self.mem_bytes() > budget.limit:
            # the pinned floor lost to the hard ceiling: demoting even
            # sketch-hot keys is LOSSLESS (they promote back on their
            # next access), so it always beats shedding.  Only the
            # in-flight MRU object must stay live.
            mru_only = (frozenset() if self._mru is _MISSING
                        else frozenset((self._mru,)))
            self._demote(budget.demote_at, mru_only)
            if self._cooldown == 0:
                self._spill_warm(budget)
        if self.mem_bytes() > budget.limit:
            self._shed(budget, pinned)

    def _demote(self, target: int, pinned: frozenset) -> None:
        """Pickle LRU hot keys into warm until hot+warm fits under the
        demote watermark (or only pinned/most-recent keys remain)."""
        hot = self._hot
        floor = max(1, len(pinned))
        for key in list(hot.keys()):
            under_bytes = self.mem_bytes() <= target
            under_keys = (self.hot_max_keys is None
                          or len(hot) <= self.hot_max_keys)
            if under_bytes and under_keys:
                return
            if len(hot) <= floor:
                return
            if key in pinned:
                continue
            value = hot.pop(key)
            self._hot_bytes -= self._hot_sizes.pop(key, 0)
            vb = pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)
            self._warm[key] = vb
            self._warm_bytes += len(vb)
            self.demotions += 1

    def _spill_warm(self, budget) -> None:
        """Move the oldest warm keys to disk, one immutable segment per
        batch, until warm pressure clears.  A write failure aborts the
        spill loudly and backs off -- the keys stay warm."""
        if self._cooldown > 0:
            self._cooldown -= 1
            return
        warm = self._warm
        while warm and self.mem_bytes() > budget.demote_at:
            batch: Dict[Any, bytes] = {}
            nb = 0
            while warm and len(batch) < self.spill_batch:
                k, vb = warm.popitem(last=False)   # oldest first
                batch[k] = vb
                nb += len(vb)
            try:
                self.spill.put_batch(batch)
            except OSError as e:
                # disk full: re-warm the batch, degrade loudly
                for k, vb in batch.items():
                    warm[k] = vb
                    warm.move_to_end(k, last=False)
                self._cooldown = _SPILL_COOLDOWN
                if self.flight is not None:
                    self.flight.record(
                        "spill_abort", node=self.node,
                        keys=len(batch), bytes=nb, error=str(e))
                return
            self._warm_bytes -= nb
            self.spilled_keys += len(batch)

    def _shed(self, budget, pinned: frozenset) -> None:
        """Past the hard ceiling with nowhere to spill: drop the
        coldest keys into dead_letters (admission-style degradation)."""
        shed = 0
        sample = None
        warm, hot = self._warm, self._hot
        while self.mem_bytes() > budget.limit:
            if warm:
                key, vb = warm.popitem(last=False)
                self._warm_bytes -= len(vb)
            elif len(hot) > 1:
                # prefer unpinned victims; under a hard ceiling even
                # sketch-hot keys shed -- but never the in-flight MRU
                # key (its caller still mutates the live object)
                key = next((k for k in hot if k not in pinned), None)
                if key is None:
                    key = next((k for k in hot if k != self._mru),
                               None)
                if key is None:
                    break
                hot.pop(key)
                self._hot_bytes -= self._hot_sizes.pop(key, 0)
            else:
                break   # a single live key never sheds
            shed += 1
            if sample is None:
                sample = key
        if not shed:
            return
        self.sheds += shed
        if self.dead_letters is not None:
            self.dead_letters.add(
                self.node, {"key": sample},
                MemoryError("state_pressure: keyed state shed under "
                            "memory budget"),
                count=shed)
        if self.flight is not None:
            self.flight.record(
                "state_pressure", node=self.node, shed=shed,
                sample_key=repr(sample), budget=budget.limit,
                mem_bytes=self.mem_bytes())

    # -- audit / sketch binding ----------------------------------------
    def bind_hot_sketch(self, hot_keys_fn) -> None:
        self.hot_keys_fn = hot_keys_fn

    def tier_of(self, key) -> Optional[str]:
        if key in self._hot:
            return "hot"
        if key in self._warm:
            return "warm"
        if key in self.spill:
            return "cold"
        return None

    def census(self):
        """(total keys, in-memory bytes estimate, per-tier extras) --
        gauge-grade, read from the auditor thread."""
        hn, wn, cn = len(self._hot), len(self._warm), len(self.spill)
        hb, wb = self._hot_bytes, self._warm_bytes
        extras = {
            "tiers": {"hot": [hn, hb], "warm": [wn, wb],
                      "cold": [cn, self.spill.disk_bytes()]},
            "spills": self.spilled_keys,
            "spill_bytes": self.spill.bytes_written,
            "promotions": self.promotions,
            "demotions": self.demotions,
            "sheds": self.sheds,
        }
        return (hn + wn + cn, hb + wb, extras)

    # -- restore / capture funnel --------------------------------------
    def materialize(self) -> Dict[Any, Any]:
        """Every key as a live value (rescale merge, schema-1
        snapshots).  Promotes nothing."""
        return dict(self.items())

    def keyed_state_pickled(self) -> Dict[Any, bytes]:
        """Per-key pickled values for the delta capture: hot keys are
        pickled fresh, warm/cold keys reuse their STORED bytes so
        unchanged keys digest identically across epochs."""
        out: Dict[Any, bytes] = {
            k: pickle.dumps(v, protocol=pickle.HIGHEST_PROTOCOL)
            for k, v in self._hot.items()}
        out.update(self._warm)
        for k, vb in self.spill.items_pickled():
            out[k] = vb
        return out

    def replace_all(self, kv: Dict[Any, Any]) -> None:
        """The single restore funnel: wipe every tier (spill segments
        included -- the disk working set never survives a restore),
        load ``kv`` hot, then re-tier under the budget."""
        self._hot = {}
        self._warm = OrderedDict()
        self._hot_sizes = {}
        self._hot_bytes = self._warm_bytes = 0
        self._mru = _MISSING
        self.spill.clear()
        for k, v in kv.items():
            sz = _size_of(v)
            self._hot[k] = v
            self._hot_sizes[k] = sz
            self._hot_bytes += sz
        self.maintain()

    def clear(self) -> None:
        self.replace_all({})
