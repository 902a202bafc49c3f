"""Core: the paper's lock-less queues, tree barrier and NUMA-aware dynamic
load balancing as a scheduler simulator on PyTorch tensors.

A runtime configuration is a :class:`~repro_torch.core.spec.RuntimeSpec` —
a point on the queue × barrier × balance lattice (``spec.py``); the paper's
five-rung mode ladder is the canned subset ``MODE_SPECS`` of that lattice.
:func:`run_schedule` runs one configuration and :func:`run_cases` /
:func:`run_grid` run a batched sweep, on the CUDA device (or on the CPU
with ``device="cpu"``).

The experiment service layers on top of the simulator:
``plan`` (what to run, in which shapes) → ``cache`` (content-addressed
on-disk results) → ``executors`` (serial / batched / sharded) → ``sweep``
(the ``run_cases``/``run_grid`` entry points) → ``tune`` (the DLB-knob
autotuner reading and writing per-(app, spec) ``experiments/tuned/``
artifacts).  Every public name of the JAX package's ``repro.core`` has a
counterpart here except its step-backend classes and environment switch
(the backend follows the device: ``backends.resolve_name``) and
``costs.jnp_where`` (``torch.where``)."""

from repro_torch.core import arrivals, backends, balance, barrier, cache, \
    dlb, executors, messaging, phases, plan, spec, state, sweep, taskgraph, \
    topology, tune, xqueue
from repro_torch.core.arrivals import (ArrivalProcess, release_times,
                                       slo_metrics)
from repro_torch.core.backends import BACKENDS, step_ops
from repro_torch.core.cache import (CODE_VERSION, ResultCache, case_key,
                                    graph_digest)
from repro_torch.core.costs import DEFAULT_COSTS, CostModel
from repro_torch.core.executors import EXECUTORS, Executor, select_executor
from repro_torch.core.phases import PHASES, StepOps
from repro_torch.core.plan import CaseSpec, ChunkPlan, SweepPlan, build_plan
from repro_torch.core.scheduler import (MODES, Run, SimResult, result, run,
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
from repro_torch.core.tune import (TunedParams, artifact_path, load_tuned,
                                   save_artifact, tune_mode, tune_spec)

__all__ = [
    "arrivals", "backends", "balance", "barrier", "cache", "dlb",
    "executors", "messaging", "phases", "plan", "spec", "state", "sweep",
    "taskgraph", "topology", "tune", "xqueue", "CaseSpec", "SweepResult",
    "run_cases", "run_grid",
    "ArrivalProcess", "release_times", "slo_metrics",
    "BACKENDS", "step_ops", "DEFAULT_COSTS", "CostModel", "StepOps",
    "PHASES", "MODES", "Run", "SimResult", "result", "run", "run_schedule",
    "AXES", "BALANCERS", "BARRIERS", "DLB_BALANCERS", "LATTICE",
    "MODE_SPECS", "OFF_LADDER", "QUEUES", "RuntimeSpec", "spec_product",
    "GraphArrays", "Params", "SimConfig", "SimState", "SweepCase",
    "from_numpy", "graph_arrays", "init_state", "make_case", "make_params",
    "to_numpy", "DMAX", "PRESETS", "MachineTopology", "TopoArrays",
    "ChunkPlan", "SweepPlan", "build_plan",
    "Executor", "EXECUTORS", "select_executor",
    "ResultCache", "CODE_VERSION", "case_key", "graph_digest",
    "TunedParams", "tune_spec", "tune_mode", "save_artifact", "load_tuned",
    "artifact_path",
]
