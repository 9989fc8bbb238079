"""Crash-safe epoch-manifest store (docs/RESILIENCE.md "Exactly-once
epochs").

One manifest per committed epoch under ``DurabilityConfig.path``:
``{magic, schema, epoch, states, offsets, meta}`` where ``states`` maps
pre-fusion node names to pickled ``state_dict`` blobs and ``offsets``
maps source names to their frontier at injection.  Every commit goes
through write-temp + flush + fsync + atomic rename (plus a best-effort
directory fsync), so a crash mid-commit leaves either the previous
manifest set intact or the new manifest complete -- never a truncated
file at the final path.  ``latest()`` is the tolerant reader: a torn,
truncated or wrong-schema manifest is skipped (newest-first) with an
``epoch_abort`` flight event naming the file, falling back to the
previous committed epoch instead of crashing the restart in
``pickle.load``.

Schema 2 (``DurabilityConfig(delta=True)``; durability/delta.py): a
keyed replica's ``states`` entry may be ``{"keyed_chain": [BlobRef,
...]}`` referencing content-addressed blobs under ``<path>/blobs/``
instead of inline bytes.  Blobs are written (atomically, skip-if-
exists) BEFORE the manifest that references them, so a committed
manifest's chain is always durable.  Readers resolve chains back to
inline bytes; ``latest()`` treats an unresolvable chain as one more
skippable damage mode with its own ``epoch_abort(blob_missing)``
event.  Blob GC is mark-and-sweep over the retained manifests after
each retire pass (and skips entirely when any retained manifest fails
to parse -- never delete what a manifest might still reference).
"""
from __future__ import annotations

import os
import pickle
import re
from typing import Dict, List, Optional, Tuple

MANIFEST_MAGIC = "windflow-epoch-manifest"
# max schema this runtime reads; commits write 1 (inline states only)
# or 2 (some states entries are blob chains) so pre-delta runtimes
# keep reading full-snapshot manifests
MANIFEST_SCHEMA = 2
_NAME_RE = re.compile(r"^epoch-(\d+)\.ckpt$")


def atomic_write_bytes(path: str, blob: bytes) -> None:
    """Write-temp + fsync + atomic rename; shared with the graph
    snapshot writer (utils/checkpoint.py)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    try:
        # persist the rename itself: without the directory fsync a
        # power loss can roll back to the old directory entry
        dfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass  # e.g. platforms that refuse O_RDONLY on directories


def load_pickle(path: str, what: str) -> object:
    """Unpickle ``path``, converting every decode failure mode of a
    torn/damaged file into one actionable RuntimeError naming it.
    Shared by the manifest reader below and the graph-snapshot reader
    (utils/checkpoint.py).  OSErrors (missing file) propagate."""
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except (pickle.UnpicklingError, EOFError, AttributeError,
            MemoryError, ValueError) as e:
        raise RuntimeError(
            f"{what} {path!r} is truncated or corrupt "
            f"({type(e).__name__}: {e}); it was written without the "
            "atomic-rename protocol or damaged on disk -- restore "
            "from an older snapshot/epoch manifest") from e


def validate_header(payload, path: str, magic: str, max_schema: int,
                    what: str) -> None:
    """Header contract shared by manifests and graph snapshots:
    foreign magic, newer schema and missing state maps all raise
    actionable errors naming the file."""
    if not isinstance(payload, dict) or payload.get("magic") != magic:
        raise RuntimeError(f"{path!r} is not a windflow {what}")
    if payload.get("schema", 0) > max_schema:
        raise RuntimeError(
            f"{what} {path!r} has schema {payload.get('schema')} "
            f"newer than this runtime supports ({max_schema}); "
            "upgrade windflow_tpu_torch to restore it")
    if not isinstance(payload.get("states"), dict):
        raise RuntimeError(
            f"{what} {path!r} carries no state map (partial write?); "
            "restore from an older snapshot")


class EpochStore:
    """Manifest directory owner: atomic commits, bounded retention,
    tolerant newest-first reads."""

    def __init__(self, path: str, retained: int = 3):
        from .delta import BlobStore
        self.dir = path
        self.retained = max(1, int(retained))
        self.blobs = BlobStore(os.path.join(path, "blobs"))
        self.fault_plan = None   # FaultPlan.fail_write (set at attach)
        os.makedirs(self.dir, exist_ok=True)

    def manifest_path(self, epoch: int) -> str:
        return os.path.join(self.dir, f"epoch-{epoch:012d}.ckpt")

    def _epochs_on_disk(self) -> List[int]:
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        out = []
        for n in names:
            m = _NAME_RE.match(n)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    # -- commit --------------------------------------------------------
    def commit(self, epoch: int, states: Dict[str, bytes],
               offsets: Dict[str, float],
               meta: Optional[dict] = None,
               blob_writes: Optional[Dict[str, bytes]] = None
               ) -> Tuple[str, int]:
        """Atomically persist epoch ``epoch``; returns (path, bytes
        written for this epoch: manifest + fresh blobs).  ``blob_writes``
        (digest -> payload) land BEFORE the manifest so a crash between
        the two leaves an unreferenced blob, never a dangling chain."""
        fp = self.fault_plan
        nbytes = 0
        if blob_writes:
            for digest, payload_b in blob_writes.items():
                self.blobs.write(digest, payload_b, fault_plan=fp)
                nbytes += len(payload_b)
        chains = any(isinstance(v, dict) and "keyed_chain" in v
                     for v in states.values())
        payload = {"magic": MANIFEST_MAGIC,
                   "schema": 2 if chains else 1,
                   "epoch": int(epoch), "states": dict(states),
                   "offsets": dict(offsets), "meta": dict(meta or {})}
        blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
        path = self.manifest_path(epoch)
        if fp is not None and fp.write_should_fail("manifest"):
            import errno
            raise OSError(errno.ENOSPC,
                          "injected disk full (epoch manifest)")
        atomic_write_bytes(path, blob)
        self._retire()
        self._gc_blobs()
        return path, len(blob) + nbytes

    def write_torn(self, epoch: int, states: Dict[str, bytes],
                   offsets: Dict[str, float]) -> str:
        """FaultPlan.torn_commit: simulate a NON-atomic writer dying
        mid-commit -- a truncated payload at the FINAL path (the
        failure the atomic rename protocol exists to prevent), which
        the tolerant reader must skip on the next restart."""
        payload = {"magic": MANIFEST_MAGIC, "schema": MANIFEST_SCHEMA,
                   "epoch": int(epoch), "states": dict(states),
                   "offsets": dict(offsets), "meta": {}}
        blob = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
        path = self.manifest_path(epoch)
        with open(path, "wb") as f:
            f.write(blob[:max(16, len(blob) // 3)])
        return path

    def _retire(self) -> None:
        epochs = self._epochs_on_disk()
        for e in epochs[:-self.retained]:
            try:
                os.remove(self.manifest_path(e))
            except OSError:
                pass

    def _gc_blobs(self) -> None:
        """Mark-and-sweep blob GC over the retained manifests.  A
        retained manifest that fails to parse vetoes the whole sweep:
        its references are unknown, and deleting a blob it still needs
        would turn one damaged epoch into an unrestorable store."""
        from .delta import chain_refs
        on_disk = self.blobs.digests_on_disk()
        if not on_disk:
            return
        live = set()
        for e in self._epochs_on_disk():
            try:
                m = self._load_raw(e)
            except RuntimeError:
                return  # unknown references: never sweep
            for ref in chain_refs(m.get("states", {})):
                live.add(ref.digest)
        for d in on_disk:
            if d not in live:
                self.blobs.unlink(d)

    # -- tolerant read -------------------------------------------------
    def _load_raw(self, epoch: int) -> dict:
        """One manifest, header-validated, chains UNresolved."""
        path = self.manifest_path(epoch)
        try:
            payload = load_pickle(path, "epoch manifest")
        except OSError as e:
            raise RuntimeError(
                f"epoch manifest {path!r} is unreadable "
                f"({type(e).__name__}: {e})") from e
        validate_header(payload, path, MANIFEST_MAGIC, MANIFEST_SCHEMA,
                        "epoch manifest")
        return payload

    def resolve_states(self, states: Dict[str, object]) -> Dict[str, bytes]:
        """Replace every ``{"keyed_chain": [...]}`` entry with inline
        packed-keyed bytes (delta.KEYED_STATE_MARKER payloads), leaving
        schema-1 inline bytes untouched.  Raises RuntimeError on a
        missing/corrupt blob."""
        from .delta import pack_keyed, resolve_chain
        out: Dict[str, bytes] = {}
        for name, v in states.items():
            if isinstance(v, dict) and "keyed_chain" in v:
                out[name] = pack_keyed(
                    resolve_chain(self.blobs, v["keyed_chain"]))
            else:
                out[name] = v
        return out

    def load(self, epoch: int) -> dict:
        """One manifest, validated and chain-resolved (``states`` holds
        inline bytes regardless of schema); raises RuntimeError with
        the path named on a torn/foreign/newer-schema file or an
        unresolvable blob chain."""
        payload = self._load_raw(epoch)
        payload["states"] = self.resolve_states(payload["states"])
        return payload

    def latest(self, flight=None) -> Tuple[Optional[int], Optional[dict]]:
        """Newest loadable manifest, skipping damaged ones newest-first
        (each skip recorded as an ``epoch_abort`` flight event when a
        recorder is given): a torn manifest is ``manifest_corrupt``, a
        manifest whose blob chain lost a link is ``blob_missing``.
        (None, None) when nothing is committed."""
        for e in reversed(self._epochs_on_disk()):
            try:
                payload = self._load_raw(e)
            except RuntimeError as err:
                if flight is not None:
                    flight.record("epoch_abort", epoch=e,
                                  reason="manifest_corrupt",
                                  path=self.manifest_path(e),
                                  error=str(err))
                continue
            try:
                payload["states"] = self.resolve_states(
                    payload["states"])
                return e, payload
            except RuntimeError as err:
                if flight is not None:
                    flight.record("epoch_abort", epoch=e,
                                  reason="blob_missing",
                                  path=self.manifest_path(e),
                                  error=str(err))
        return None, None
