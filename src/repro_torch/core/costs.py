"""Latency cost model for the scheduler simulator.

All constants are in *nanoseconds* and are taken from the paper's own numbers
(§IV-B: lock-less cell communication through shared caches is "a few
nanoseconds"; atomic inter-core operations have "typical lower-bound
per-access latencies of around 100 ns") plus standard published figures for
Skylake-SP cache/NUMA latencies.

The simulator charges these costs to per-worker *virtual clocks*.  Makespan is
causally correct through queue timestamps: a consumer's clock is advanced to at
least the producer-side timestamp of any task it pops.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CostModel:
    # Lock-less access to memory the worker owns / has cached (L1/L2 hit).
    c_cache: int = 2
    # Lock-less access to another core's cache line in the same NUMA zone
    # (LLC / cross-core snoop).
    c_zone: int = 30
    # Lock-less access to a cache line homed in a remote NUMA zone.
    c_numa: int = 100
    # One atomic read-modify-write (CAS / lock xadd), uncontended.
    c_atomic: int = 100
    # Extra serialization penalty per *contender* on the same atomic/lock:
    # the k-th simultaneous contender pays k * c_contend on top of c_atomic.
    c_contend: int = 120
    # Full hand-off of GOMP's global task lock under contention (futex park /
    # wake + critical-section bookkeeping; calibrated to the paper's observed
    # ~40 K tasks/s for GOMP on fine-grained PoSp, §VII).
    c_lock: int = 2500
    # Cost of one priority-queue operation inside GOMP's critical section.
    c_pq_op: int = 40
    # Task allocation (malloc) cost. GOMP mallocs per task under contention;
    # XGOMP/XGOMPTB reuse buffers (paper §VI-A).
    c_alloc: int = 60
    # Writing one queue slot (the data movement itself).
    c_slot: int = 2
    # Execution-time NUMA penalty multipliers (paper SVI-B: memory-bound
    # tasks run faster near their data; STRAS/Sort gain ~4x from locality).
    # Effective duration = dur * (1 + mem_bound * (penalty - 1)).
    # Remote penalty reflects cross-socket DRAM *bandwidth* sharing for
    # streaming tasks (~3x), not just latency.
    exec_zone_penalty: float = 1.3
    exec_remote_penalty: float = 3.0
    # Size in bytes of one steal-request / steal-reply control message —
    # the D of the cluster tier's L + D/B link pricing for protocol
    # traffic (task payloads price the data traffic).  Only read on
    # cluster topologies; flat and single-node machines never charge it.
    req_bytes: int = 64


DEFAULT_COSTS = CostModel()
