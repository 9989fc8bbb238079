"""Worker-process entry point::

    python -m windflow_tpu_torch.distributed.worker '<spec json>'

Spawned by :func:`windflow_tpu_torch.distributed.run_distributed` (one
process per worker).  The spec carries the worker id, the shuffle
endpoints, importable references to the user's build/config functions
and the restore epoch -- see distributed/runtime.py.  Kept to a thin
shim so a clean interpreter imports only what the partition actually
runs (a host-only partition never touches the card).
"""
from __future__ import annotations

import json
import sys


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m windflow_tpu_torch.distributed.worker "
              "'<spec json>'", file=sys.stderr)
        return 2
    from .runtime import worker_main
    return worker_main(json.loads(argv[0]))


if __name__ == "__main__":
    sys.exit(main())
