"""Worker identity of a distributed-runtime process.

Every worker process of a distributed PipeGraph run sets
``WINDFLOW_WORKER_ID`` before building its graph (distributed/worker.py
does it first thing); log-producing surfaces that key their file names
by ``<pid>_<graph>`` add the worker component through
:func:`worker_suffix`, so two workers of the same graph on one box --
and a worker restarted into a recycled pid -- can never clobber each
other's ``log/*_stats.json`` / ``*_flight.jsonl`` artifacts, and an
offline reader (the doctor's ``--merge``) can group files per worker.

Dependency-free on purpose: monitoring and telemetry import this from
below the distributed plane.
"""
from __future__ import annotations

import os
from typing import Optional

ENV_WORKER_ID = "WINDFLOW_WORKER_ID"


def worker_id() -> Optional[int]:
    """This process's worker id, or None outside a distributed run."""
    raw = os.environ.get(ENV_WORKER_ID)
    if raw is None or raw == "":
        return None
    try:
        return int(raw)
    except ValueError:
        return None


def worker_suffix() -> str:
    """File-name component: ``"_w<id>"`` in a worker, else ``""``."""
    wid = worker_id()
    return "" if wid is None else f"_w{wid}"
