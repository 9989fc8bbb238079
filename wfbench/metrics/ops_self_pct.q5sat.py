"""ops_self_pct.q5sat: ``ops_self_pct`` on a cell whose window engine
takes watermarks.  The engine's ``windflow/watermark`` ranges (its
firing by event time, the freeing of keys and the launches of what
fired, on the chain's thread, read by ``watermark_pct``) lie inside the
source's ``windflow/op/*`` range, so they are taken out of the
operators' self time like the other nested ranges."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    "wfbench_metric_ops_self_pct_watermarked",
    Path(__file__).with_name("ops_self_pct.py"))
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)
_base.NESTED = _base.NESTED + ("windflow/watermark",)


def read(run):
    return _base.read(run)
