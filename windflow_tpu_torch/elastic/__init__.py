"""Elastic scaling plane: load-driven runtime rescaling with
keyed-state migration (docs/ELASTIC.md).

The capability the reference lacks outright (SURVEY.md: "no
rescaling" -- replica counts frozen at build time) and the survey's
production gap: DS2 (Kalavri et al., OSDI '18) for the scaling policy,
Flink's key-group state reassignment (Carbone et al., VLDB '17) for
the migration mechanics.  Three parts:

* :mod:`signals` -- per-operator LoadReports from service-time EWMAs,
  channel depth gauges and ingest credit-wait time;
* :mod:`controller` -- hysteresis controller emitting scale decisions
  inside each operator's declared ``[min, max]`` interval;
* :mod:`rescale` -- the epoch-based pause-drain-migrate protocol
  (quiesce barrier, keyed-state repartition by the emitter's
  ``hash % parallelism`` contract, replica/channel rewiring).

Declare with ``.with_elasticity(min, max, target_util)`` on a builder;
tune with ``RuntimeConfig.elasticity = ElasticityConfig(...)``; drive
manually with ``PipeGraph.rescale(name, n)``.
"""
from ..core.basic import ElasticSpec
from .controller import ElasticController, ElasticityConfig, decide, \
    start_controller
from .rescale import (ElasticHandle, RescaleError, RescaleEvent,
                      merge_keyed_states, owner_of, partition_keyed_state,
                      rescale_operator)
from .signals import LoadReport, OperatorSignals, SignalSampler

__all__ = [
    "ElasticSpec", "ElasticityConfig", "ElasticController", "decide",
    "start_controller", "ElasticHandle", "RescaleError", "RescaleEvent",
    "merge_keyed_states", "owner_of", "partition_keyed_state",
    "rescale_operator", "LoadReport", "OperatorSignals", "SignalSampler",
]
