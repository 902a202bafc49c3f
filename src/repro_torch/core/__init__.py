"""Core: the paper's lock-less queues, tree barrier and NUMA-aware dynamic
load balancing as a scheduler simulator on PyTorch tensors.

A runtime configuration is a :class:`~repro_torch.core.spec.RuntimeSpec` —
a point on the queue × barrier × balance lattice (``spec.py``); the paper's
five-rung mode ladder is the canned subset ``MODE_SPECS`` of that lattice.
:func:`run_schedule` runs one configuration and :func:`run_cases` /
:func:`run_grid` run a batched sweep, on the CUDA device (or on the CPU
with ``device="cpu"``)."""

from repro_torch.core import arrivals, backends, barrier, cache, dlb, \
    executors, messaging, phases, plan, spec, state, sweep, taskgraph, \
    topology, xqueue
from repro_torch.core.arrivals import (ArrivalProcess, release_times,
                                       slo_metrics)
from repro_torch.core.backends import BACKENDS, step_ops
from repro_torch.core.costs import DEFAULT_COSTS, CostModel
from repro_torch.core.phases import StepOps
from repro_torch.core.plan import CaseSpec
from repro_torch.core.scheduler import (Run, SimResult, result, run,
                                        run_schedule)
from repro_torch.core.spec import (AXES, BALANCERS, BARRIERS, DLB_BALANCERS,
                                   LATTICE, MODE_SPECS, OFF_LADDER, QUEUES,
                                   RuntimeSpec, spec_product)
from repro_torch.core.state import (GraphArrays, Params, SimConfig, SimState,
                                    SweepCase, from_numpy, graph_arrays,
                                    init_state, make_case, make_params,
                                    to_numpy)
from repro_torch.core.sweep import SweepResult, run_cases, run_grid
from repro_torch.core.topology import (DMAX, PRESETS, MachineTopology,
                                       TopoArrays)

__all__ = [
    "arrivals", "backends", "barrier", "cache", "dlb", "executors",
    "messaging", "phases", "plan", "spec", "state", "sweep", "taskgraph",
    "topology", "xqueue", "CaseSpec", "SweepResult", "run_cases", "run_grid",
    "ArrivalProcess", "release_times", "slo_metrics",
    "BACKENDS", "step_ops", "DEFAULT_COSTS", "CostModel", "StepOps",
    "Run", "SimResult", "result", "run", "run_schedule",
    "AXES", "BALANCERS", "BARRIERS", "DLB_BALANCERS", "LATTICE",
    "MODE_SPECS", "OFF_LADDER", "QUEUES", "RuntimeSpec", "spec_product",
    "GraphArrays", "Params", "SimConfig", "SimState", "SweepCase",
    "from_numpy", "graph_arrays", "init_state", "make_case", "make_params",
    "to_numpy", "DMAX", "PRESETS", "MachineTopology", "TopoArrays",
]
