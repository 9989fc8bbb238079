"""Crash-safe cold-tier spill segments (docs/RESILIENCE.md "Tiered
state & memory pressure").

A :class:`SpillStore` owns one directory of immutable segment files,
each holding a batch of cold keys as pre-pickled bytes::

    seg-00000042-<sha256-of-payload>.spill

Writes follow the same write-temp + fsync + atomic-rename protocol as
the epoch manifests (``durability/store.py``), and the payload digest
rides in the file NAME, so a segment either lands complete or not at
all -- a crash mid-spill leaves at most a ``.tmp`` orphan the next
incarnation wipes.  Reads re-hash the payload against the name; a torn
or bit-flipped segment surfaces as a RuntimeError at the replica's
next access to one of its keys, which under supervision is a healable
crash (fresh replica, rewind to the last committed epoch) rather than
silently-wrong state.

The spill directory is a RUNTIME WORKING SET, not a durability
surface: epoch manifests/blob chains remain the single source of
truth, every restore path funnels through ``load_keyed_state`` →
``TieredKeyedStore.replace_all`` which starts from an empty spill dir.
That is the crash-safety argument in one line -- kill-restart
mid-spill bitwise-matches an uninterrupted run because nothing under
this directory is ever read across a restart.

The in-memory index (key → segment seq) is the only record of where a
key lives; per-segment live counts drive space reclamation: a segment
whose keys were all deleted/re-promoted is unlinked, and ``compact()``
rewrites the survivors of mostly-dead segments into a fresh one.
"""
from __future__ import annotations

import errno
import hashlib
import os
import pickle
from collections import OrderedDict
from typing import Any, Dict, List, Optional

SPILL_MAGIC = "windflow-spill-segment"
# segments with a live fraction below this are rewritten by compact()
COMPACT_LIVE_FRAC = 0.5
# bounded cache of decoded segments (reads cluster by segment)
_READ_CACHE_SEGS = 4


def _digest(payload: bytes) -> str:
    return hashlib.sha256(payload).hexdigest()


class SpillStore:
    """One replica's cold tier: immutable digest-named segment files
    plus the in-memory key index.  Single-writer (the replica thread);
    gauge reads (census) only touch plain counters."""

    def __init__(self, root: str):
        self.root = root
        self.fault_plan = None      # FaultPlan.fail_write("spill") hook
        self._seq = 0
        self._index: Dict[Any, int] = {}        # key -> segment seq
        self._seg_path: Dict[int, str] = {}     # seq -> file path
        self._seg_total: Dict[int, int] = {}    # seq -> keys at write
        self._seg_live: Dict[int, int] = {}     # seq -> live keys now
        self._cache: "OrderedDict[int, Dict[Any, bytes]]" = OrderedDict()
        self.bytes_written = 0                  # lifetime spill volume
        self.segments_written = 0
        os.makedirs(self.root, exist_ok=True)
        self._wipe()                            # working set: start clean

    # -- lifecycle -----------------------------------------------------
    def _wipe(self) -> None:
        for n in os.listdir(self.root):
            if n.endswith(".spill") or n.endswith(".tmp"):
                try:
                    os.unlink(os.path.join(self.root, n))
                except OSError:
                    pass

    def clear(self) -> None:
        """Drop every key and segment (restore paths start here)."""
        self._index.clear()
        self._seg_path.clear()
        self._seg_total.clear()
        self._seg_live.clear()
        self._cache.clear()
        self._wipe()

    # -- writes --------------------------------------------------------
    def put_batch(self, entries: Dict[Any, bytes]) -> int:
        """Spill a batch of keys (pre-pickled values) as ONE immutable
        segment; returns bytes written.  Raises OSError (e.g. ENOSPC)
        without mutating the index -- the caller keeps the keys warm
        and degrades (``spill_abort``)."""
        if not entries:
            return 0
        fp = self.fault_plan
        if fp is not None and fp.write_should_fail("spill"):
            raise OSError(errno.ENOSPC,
                          "injected disk full (spill segment)")
        seq = self._seq
        payload = pickle.dumps(
            {"magic": SPILL_MAGIC, "seq": seq, "entries": dict(entries)},
            protocol=pickle.HIGHEST_PROTOCOL)
        path = os.path.join(
            self.root, f"seg-{seq:08d}-{_digest(payload)}.spill")
        from ..durability.store import atomic_write_bytes
        atomic_write_bytes(path, payload)
        # index mutations only after the segment is durable
        self._seq = seq + 1
        self._seg_path[seq] = path
        self._seg_total[seq] = len(entries)
        self._seg_live[seq] = 0
        for k in entries:
            self._drop_ref(k)           # key may move cold -> cold
            self._index[k] = seq
            self._seg_live[seq] += 1
        self.bytes_written += len(payload)
        self.segments_written += 1
        return len(payload)

    # -- reads ---------------------------------------------------------
    def _load_segment(self, seq: int) -> Dict[Any, bytes]:
        got = self._cache.get(seq)
        if got is not None:
            self._cache.move_to_end(seq)
            return got
        path = self._seg_path[seq]
        try:
            with open(path, "rb") as f:
                payload = f.read()
        except OSError as e:
            raise RuntimeError(
                f"spill segment {path!r} missing or unreadable: "
                f"{e}") from e
        name_digest = os.path.basename(path).rsplit("-", 1)[-1][:-6]
        if _digest(payload) != name_digest:
            raise RuntimeError(
                f"spill segment {path!r} fails its content digest "
                "(torn or corrupt write)")
        doc = pickle.loads(payload)
        if not isinstance(doc, dict) or doc.get("magic") != SPILL_MAGIC:
            raise RuntimeError(
                f"file at {path!r} is not a windflow spill segment")
        entries = doc["entries"]
        self._cache[seq] = entries
        while len(self._cache) > _READ_CACHE_SEGS:
            self._cache.popitem(last=False)
        return entries

    def get(self, key) -> Optional[bytes]:
        """Pickled bytes of ``key``, or None when not spilled.  Raises
        RuntimeError on a torn segment."""
        seq = self._index.get(key)
        if seq is None:
            return None
        return self._load_segment(seq)[key]

    def __contains__(self, key) -> bool:
        return key in self._index

    def __len__(self) -> int:
        return len(self._index)

    def keys(self):
        return self._index.keys()

    def items_pickled(self):
        """Every (key, pickled bytes) -- restore/capture reads."""
        for k, seq in list(self._index.items()):
            yield k, self._load_segment(seq)[k]

    # -- deletes + space reclamation -----------------------------------
    def _drop_ref(self, key) -> None:
        seq = self._index.pop(key, None)
        if seq is None:
            return
        live = self._seg_live.get(seq, 0) - 1
        self._seg_live[seq] = live
        if live <= 0:
            self._unlink_seg(seq)

    def _unlink_seg(self, seq: int) -> None:
        path = self._seg_path.pop(seq, None)
        self._seg_total.pop(seq, None)
        self._seg_live.pop(seq, None)
        self._cache.pop(seq, None)
        if path is not None:
            try:
                os.unlink(path)
            except OSError:
                pass

    def discard(self, key) -> None:
        """Remove ``key``; a segment with no live keys left is
        unlinked."""
        self._drop_ref(key)

    def compact(self) -> int:
        """Rewrite the live keys of mostly-dead segments into a fresh
        segment; returns bytes written (0 when nothing qualified).
        Write failures propagate like ``put_batch``."""
        victims = [s for s, total in self._seg_total.items()
                   if total and self._seg_live.get(s, 0) / total
                   < COMPACT_LIVE_FRAC]
        if not victims:
            return 0
        vic = set(victims)
        move: Dict[Any, bytes] = {}
        for k, seq in list(self._index.items()):
            if seq in vic:
                move[k] = self._load_segment(seq)[k]
        if not move:
            for s in victims:
                self._unlink_seg(s)
            return 0
        return self.put_batch(move)   # re-index drops the old refs

    # -- gauges --------------------------------------------------------
    def disk_bytes(self) -> int:
        total = 0
        try:
            paths = list(self._seg_path.values())
        except RuntimeError:      # gauge read racing a writer resize
            return total
        for path in paths:
            try:
                total += os.path.getsize(path)
            except OSError:
                pass
        return total
