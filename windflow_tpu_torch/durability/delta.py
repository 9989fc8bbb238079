"""Incremental (delta) epoch snapshots (docs/RESILIENCE.md
"Delta snapshots").

The schema-1 manifest re-pickles every replica's full keyed state each
epoch -- O(total keys) commit cost no matter how few keys the epoch
touched.  With ``DurabilityConfig(delta=True)`` a keyed replica's
state is serialized as content-addressed **blobs** beside the manifest
and the manifest references a blob CHAIN instead of inlining bytes:

* the chain's first link is a **base** blob holding every key's
  pickled value;
* each later link is a **delta** blob holding only the keys that
  changed (``put``) or disappeared (``del``) since the previous link;
* after ``delta_chain_max`` links the encoder compacts the chain back
  to a fresh base blob, bounding replay length.

Blobs are content-addressed (file name = sha256 of the payload), so an
unchanged base is never rewritten -- consecutive manifests share it by
reference, and a commit under a 1%-dirty workload writes O(changed
keys) bytes.  Dirty detection is a per-key digest diff against the
encoder's shadow of the last committed chain (the blob-granular
analogue of the audit plane's keyed-state census deltas).

Readers walk the chain base-first, applying puts/dels; a missing or
corrupt blob raises, and the tolerant manifest scan
(``EpochStore.latest``) records an ``epoch_abort(blob_missing)``
flight event and falls back to the newest fully-loadable epoch.

Non-keyed state (source offsets, window engines without the keyed
contract) stays inline in the manifest exactly as at schema 1: it is
small, and inlining keeps the torn-blob failure domain to keyed
stores only.
"""
from __future__ import annotations

import hashlib
import os
import pickle
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

BLOB_MAGIC = "windflow-epoch-blob"

# resolved keyed manifest entries unpickle to this marker shape instead
# of a logic state_dict: {"__windflow_keyed_state__": True,
# "entries": {key: pickled_value_bytes}}.  ``load_into`` routes it to
# ``load_keyed_state`` so every restore path (epoch restore, live
# checkpoint, worker restart, supervision rewind) stays delta-agnostic.
KEYED_STATE_MARKER = "__windflow_keyed_state__"


@dataclass(frozen=True)
class BlobRef:
    """Pickle-friendly chain link: content digest + payload size."""

    digest: str
    nbytes: int
    base: bool = False


def _digest(payload: bytes) -> str:
    return hashlib.sha256(payload).hexdigest()


def pack_keyed(entries: Dict[Any, bytes]) -> bytes:
    """Serialize per-key pickled values as a marker payload whose
    unpickled form ``load_into`` recognizes."""
    return pickle.dumps({KEYED_STATE_MARKER: True, "entries": entries},
                        protocol=pickle.HIGHEST_PROTOCOL)


def is_keyed_payload(obj: Any) -> bool:
    return isinstance(obj, dict) and obj.get(KEYED_STATE_MARKER) is True


def unpack_keyed(obj: Dict[str, Any]) -> Dict[Any, Any]:
    """Marker payload -> {key: live value} (per-key unpickle)."""
    return {k: pickle.loads(v) for k, v in obj["entries"].items()}


def keyed_capable(logic) -> bool:
    """True iff the logic's class implements the FULL keyed contract
    (both ``keyed_state_dict`` and ``load_keyed_state`` overridden), so
    its state can round-trip through per-key blobs."""
    from ..runtime.node import NodeLogic
    kd = getattr(type(logic), "keyed_state_dict", None)
    lk = getattr(type(logic), "load_keyed_state", None)
    if kd is None or lk is None:
        return False
    return (kd is not getattr(NodeLogic, "keyed_state_dict", None)
            and lk is not getattr(NodeLogic, "load_keyed_state", None))


def load_into(logic, decoded: Any) -> None:
    """Load a decoded manifest/snapshot entry into a live logic,
    routing keyed marker payloads through ``load_keyed_state`` and
    everything else through ``load_state`` -- the single restore
    funnel shared by epoch restore, live checkpoints, distributed
    worker restarts and the replica supervisor."""
    if is_keyed_payload(decoded):
        logic.load_keyed_state(unpack_keyed(decoded))
    else:
        logic.load_state(decoded)


class KeyedCapture:
    """Replica-thread capture of a keyed logic's state as per-key
    pickled values.  Pickling per key (instead of one state_dict blob)
    happens on the replica thread -- values alias live stores, so they
    must be frozen before the coordinator thread diffs them."""

    __slots__ = ("entries",)

    def __init__(self, entries: Dict[Any, bytes]):
        self.entries = entries

    @classmethod
    def capture(cls, logic) -> "KeyedCapture":
        # tiered stores (state/tiers.py) serve warm/cold keys from the
        # pickled bytes they already hold -- unchanged cold keys digest
        # identically every epoch, so the chain references them with
        # zero new blob bytes ("cold tier by reference")
        fast = getattr(logic, "keyed_state_pickled", None)
        if fast is not None:
            got = fast()
            if got is not None:
                return cls(dict(got))
        return cls({k: pickle.dumps(v, protocol=pickle.HIGHEST_PROTOCOL)
                    for k, v in logic.keyed_state_dict().items()})


class BlobStore:
    """Content-addressed blob files under ``<epochs>/blobs/``.

    Writes are atomic (durability/store.py) and skip-if-exists --
    content addressing makes rewrites byte-identical, so an existing
    file is already the payload.  Reads verify the digest, so a torn
    or bit-flipped blob surfaces as a RuntimeError instead of a bad
    unpickle deep inside restore."""

    def __init__(self, root: str):
        self.root = root

    def path(self, digest: str) -> str:
        return os.path.join(self.root, f"{digest}.blob")

    def write(self, digest: str, payload: bytes, fault_plan=None) -> str:
        from .store import atomic_write_bytes
        p = self.path(digest)
        if not os.path.exists(p):
            if fault_plan is not None \
                    and fault_plan.write_should_fail("blob"):
                import errno
                raise OSError(errno.ENOSPC,
                              "injected disk full (epoch blob)")
            os.makedirs(self.root, exist_ok=True)
            atomic_write_bytes(p, payload)
        return p

    def read(self, digest: str) -> bytes:
        p = self.path(digest)
        try:
            with open(p, "rb") as f:
                payload = f.read()
        except OSError as e:
            raise RuntimeError(
                f"epoch blob {digest[:12]}... missing or unreadable at "
                f"{p!r}: {e}") from e
        if _digest(payload) != digest:
            raise RuntimeError(
                f"epoch blob at {p!r} fails its content digest "
                "(torn or corrupt write)")
        return payload

    def digests_on_disk(self) -> List[str]:
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        return [n[:-5] for n in names if n.endswith(".blob")]

    def unlink(self, digest: str) -> None:
        try:
            os.unlink(self.path(digest))
        except OSError:
            pass


def make_blob(base: bool, put: Dict[Any, bytes],
              dels: List[Any]) -> bytes:
    return pickle.dumps(
        {"magic": BLOB_MAGIC, "base": base, "put": put, "del": dels},
        protocol=pickle.HIGHEST_PROTOCOL)


def _load_blob(store: BlobStore, ref: BlobRef) -> Dict[str, Any]:
    payload = store.read(ref.digest)
    try:
        doc = pickle.loads(payload)
    except Exception as e:  # digest passed but unpickle failed
        raise RuntimeError(
            f"epoch blob {ref.digest[:12]}... unreadable: {e!r}") from e
    if not isinstance(doc, dict) or doc.get("magic") != BLOB_MAGIC:
        raise RuntimeError(
            f"file at {store.path(ref.digest)!r} is not a windflow "
            "epoch blob")
    return doc


def resolve_chain(store: BlobStore, chain: List[BlobRef]) -> Dict[Any, bytes]:
    """Walk a blob chain base-first, applying puts/dels; returns the
    merged {key: pickled_value_bytes}.  Raises RuntimeError on a
    missing/corrupt/ill-formed link (the tolerant manifest scan turns
    that into an ``epoch_abort(blob_missing)`` fallback)."""
    if not chain:
        return {}
    entries: Dict[Any, bytes] = {}
    for i, ref in enumerate(chain):
        doc = _load_blob(store, ref)
        if i == 0 and not doc.get("base"):
            raise RuntimeError(
                f"epoch blob chain starts with a delta blob "
                f"({ref.digest[:12]}...): base link missing")
        entries.update(doc.get("put", {}))
        for k in doc.get("del", ()):  # removed keys
            entries.pop(k, None)
    return entries


class DeltaEncoder:
    """Per-replica chain encoder living on the coordinator thread.

    Keeps a shadow of the last committed chain (per-key value digests
    for dirty detection, the pickled values themselves for
    compaction) and turns each epoch's :class:`KeyedCapture` into the
    blob writes + manifest chain for that epoch."""

    __slots__ = ("shadow", "entries", "chain", "chain_max")

    def __init__(self, chain_max: int = 8):
        self.shadow: Dict[Any, str] = {}     # key -> value digest
        self.entries: Dict[Any, bytes] = {}  # key -> pickled value
        self.chain: List[BlobRef] = []
        self.chain_max = max(1, int(chain_max))

    def encode(self, capture: KeyedCapture,
               blob_writes: Dict[str, bytes]) -> List[BlobRef]:
        """Diff ``capture`` against the shadow; stage the blob write
        for this epoch into ``blob_writes`` (digest -> payload) and
        return the manifest chain.  An epoch that touched nothing
        reuses the previous chain verbatim -- zero new bytes."""
        put: Dict[Any, bytes] = {}
        new_shadow: Dict[Any, str] = {}
        for k, vb in capture.entries.items():
            d = _digest(vb)
            new_shadow[k] = d
            if self.shadow.get(k) != d:
                put[k] = vb
        dels = [k for k in self.shadow if k not in capture.entries]
        self.shadow = new_shadow
        self.entries.update(put)
        for k in dels:
            self.entries.pop(k, None)
        if not self.chain:
            # first commit for this replica: full base
            payload = make_blob(True, dict(self.entries), [])
            ref = BlobRef(_digest(payload), len(payload), base=True)
            blob_writes[ref.digest] = payload
            self.chain = [ref]
        elif put or dels:
            if len(self.chain) >= self.chain_max:
                # compact: fresh base replaces the whole chain
                payload = make_blob(True, dict(self.entries), [])
                ref = BlobRef(_digest(payload), len(payload), base=True)
                blob_writes[ref.digest] = payload
                self.chain = [ref]
            else:
                payload = make_blob(False, put, dels)
                ref = BlobRef(_digest(payload), len(payload))
                blob_writes[ref.digest] = payload
                self.chain = self.chain + [ref]
        # else: nothing changed -- previous chain carries over
        return list(self.chain)


def chain_refs(states: Dict[str, Any]):
    """Yield every BlobRef referenced by a manifest ``states`` map
    (delta entries are ``{"keyed_chain": [BlobRef, ...]}``)."""
    for v in states.values():
        if isinstance(v, dict) and "keyed_chain" in v:
            for ref in v["keyed_chain"]:
                yield ref
