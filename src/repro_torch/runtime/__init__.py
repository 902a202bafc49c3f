"""The distributed runtime: the tree all-reduce over a ``DeviceMesh``
(``collectives``) and fault tolerance for the train loop."""

from repro_torch.runtime.collectives import (flat_psum_grads,
                                             hierarchical_psum_grads,
                                             tree_allreduce)
from repro_torch.runtime.fault_tolerance import (SimulatedFault,
                                                 StragglerMonitor,
                                                 Supervisor)

__all__ = ["SimulatedFault", "StragglerMonitor", "Supervisor",
           "flat_psum_grads", "hierarchical_psum_grads", "tree_allreduce"]
