"""Fault tolerance for the train loop (its tree all-reduce,
``collectives``, is distributed work: ROADMAP item 11)."""

from repro_torch.runtime.fault_tolerance import (SimulatedFault,
                                                 StragglerMonitor,
                                                 Supervisor)

__all__ = ["SimulatedFault", "StragglerMonitor", "Supervisor"]
