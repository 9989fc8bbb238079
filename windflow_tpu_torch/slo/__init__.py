"""SLO plane: declared objectives, continuously evaluated
(docs/OBSERVABILITY.md "SLO plane").

A graph declares what "healthy" means -- an end-to-end p99 budget, a
throughput floor, a frontier-lag ceiling -- and the runtime holds
itself to it on the existing diagnosis tick with multi-window
error-budget burn-rate accounting.  Breaches open ``slo_breach``
flight episodes, surface as the ``Slo`` stats block, the
``windflow_slo_*`` metric families and a worst-news-first doctor
verdict line, and (in a distributed run) fold into the coordinator's
live merged cluster view.
"""
from .plane import SloConfig, SloTracker

__all__ = ["SloConfig", "SloTracker"]
