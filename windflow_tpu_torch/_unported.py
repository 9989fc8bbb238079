"""Parts of the reference package this port does not carry yet.

Each entry names the ROADMAP.md queue-A item that will port it.  Code
paths that would need one raise :func:`unported` instead of running a
partial or silent substitute.
"""
from __future__ import annotations

ROADMAP_ITEMS = {
    "serving": "ROADMAP.md A10h (serving and the global scheduler)",
    "mesh": "ROADMAP.md A11 (mesh plane)",
}


def unported(what: str, item: str) -> NotImplementedError:
    """The error a code path raises when it needs ``what``, which the
    ROADMAP item ``item`` (a key of :data:`ROADMAP_ITEMS`) will port."""
    return NotImplementedError(
        f"{what} is not ported to windflow_tpu_torch yet: "
        f"{ROADMAP_ITEMS[item]}")
