"""Machine-topology model: hierarchical NUMA domains as sweepable data.

The paper's central claim is about *multi-socket* machines — NUMA-aware
balancing wins precisely because crossing a socket boundary costs more than
staying local — yet the simulator historically modeled a flat worker array
with one scalar ``zone_size`` and a single cross-zone latency.  This module
makes the machine itself first-class and sweepable:

* :class:`MachineTopology` — the host-side description: ``n_sockets`` ×
  ``cores_per_socket`` plus a symmetric NUMA *distance matrix* (ns per
  lock-less remote-line touch, the same unit as ``CostModel.c_numa``).
  Hashable and JSON-able, so it can key a case and a result cache.
* :class:`TopoArrays` — the tuple of tensors the simulator consumes, carried
  in ``SweepCase``: the padded ``(DMAX, DMAX)`` distance matrix, the live
  domain count, and a ``flat`` flag.  Every field is a tensor on the run's
  device, so topology branching is mask arithmetic, never Python ``if``.

Backward-compatibility contract (the ``flat`` flag): the historical flat
model — two latency levels, ``c_zone`` intra-zone / ``c_numa`` inter-zone,
victim choice NUMA-local with probability ``p_local`` and uniform among all
remote workers otherwise, a ``ceil(log2 W)``-level tree barrier — is the
*degenerate point* of this model.  Cases built without a topology (and
topologies built via :meth:`MachineTopology.flat`) set ``flat=True``, which
routes every consumer (``phases.comm_cost``, ``dlb.pick_victim``,
``barrier.episode_for``) through arithmetic bitwise identical to the
pre-topology code — tests/test_topology.py and tests/test_golden_modes.py
hold that line.  Non-flat topologies switch the same call sites to the
hierarchy: communication and steal/transfer latencies are distance-matrix
lookups between the endpoints' domains, remote victims are sampled with
probability inversely related to domain distance, and the tree barrier's
layout follows the socket hierarchy (intra-socket subtrees, then
socket-level merges priced at the actual inter-socket distance).

Workers map onto domains by index blocks: worker ``w`` lives in domain
``min(w // zone_size, n_domains - 1)`` with ``zone_size = max(n_workers //
n_sockets, 1)`` — the same arithmetic the flat model used for zones, so a
topology's sockets *are* the zones of every other subsystem (counters,
locality penalties, messaging costs).

Cluster tier (``n_nodes > 1``): sockets group into *nodes* by contiguous
index blocks (``node_of_socket = s // (n_sockets // n_nodes)``), and every
link additionally carries a *bandwidth* in bytes/ns.  On cluster
topologies every cross-worker charge becomes ``L + payload / B`` — the
distance-matrix latency plus the task's payload divided by the link
bandwidth between the endpoints' sockets — and all cross-node traffic in
a step additionally shares one *bottleneck* inter-node link
(``bottleneck_bw``), priced as a per-step occupancy charge (see
``phases.step_pipeline``).  Single-node topologies (and the flat model)
set ``cluster=False``, which zeroes every payload term and skips the
bottleneck charge, keeping them bitwise identical to the pre-cluster
engine; ``cache_key``/``asdict`` add the cluster fields only when
``n_nodes > 1`` so existing cache entries and tuner artifacts stay valid.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.costs import DEFAULT_COSTS

#: static padded width of the distance matrix — one shape for every
#: topology of socket count ≤ DMAX (the same padding as the JAX package)
DMAX = 8


class TopoArrays(NamedTuple):
    """The tensor view of a topology (one ``SweepCase`` field).

    ``dist`` is padded to ``(DMAX, DMAX)``; only the leading ``n_domains``
    rows/columns are ever read (consumers clip domain ids into range).
    ``flat`` selects the legacy two-level arithmetic — see the module
    docstring's compatibility contract.
    """
    n_domains: torch.Tensor  # int32 scalar — live rows/cols of ``dist``
    dist: torch.Tensor       # (DMAX, DMAX) int32 — inter-domain latency, ns
    flat: torch.Tensor       # bool scalar — legacy flat-model semantics
    node: torch.Tensor       # (DMAX,) int32 — node id of each socket
    bw: torch.Tensor         # (DMAX, DMAX) int32 — link bandwidth, bytes/ns
    cluster: torch.Tensor    # bool scalar — n_nodes > 1: payload pricing on
    bneck_bw: torch.Tensor   # int32 scalar — shared inter-node link, bytes/ns
    bw_scale: torch.Tensor   # float32 scalar — cross-node fabric bandwidth
                            # relative to the preset's native fabric, in
                            # (0, 1]; steers the victim policy's cross-node
                            # stratum (dlb.pick_victim), 1.0 = native


def domain_of(w: torch.Tensor, zone_size, n_domains) -> torch.Tensor:
    """Domain id of worker ``w`` (all arguments may be tensors).  The clip
    keeps padded worker lanes addressable inside the padded matrix."""
    last = torch.as_tensor(n_domains - 1, device=w.device)
    return torch.minimum(w // zone_size, last).to(torch.int32)


def _legacy_matrix(n: int) -> Tuple[Tuple[int, ...], ...]:
    """The flat model's two-level matrix: c_zone intra, c_numa inter."""
    c = DEFAULT_COSTS
    return tuple(tuple(c.c_zone if i == j else c.c_numa for j in range(n))
                 for i in range(n))


@dataclasses.dataclass(frozen=True)
class MachineTopology:
    """Host-side machine description: sockets × cores and NUMA distances.

    ``dist`` is a symmetric ``n_sockets``-square tuple-of-tuples in
    nanoseconds — the lock-less latency of touching a cache line homed in
    the other socket (diagonal: intra-socket cross-core, i.e. the flat
    model's ``c_zone``).  ``cores_per_socket`` records the modeled
    machine's natural size (``natural_workers``); simulated cases may run
    any worker count, splitting workers evenly over sockets.
    """
    name: str
    n_sockets: int
    cores_per_socket: int
    dist: Tuple[Tuple[int, ...], ...]
    is_flat: bool = False
    #: cluster tier — sockets group into nodes by contiguous index blocks;
    #: 1 means the whole machine is one node (no payload pricing)
    n_nodes: int = 1
    #: per-link bandwidth in bytes/ns, same square shape as ``dist``;
    #: required on cluster topologies, ignored (may be None) otherwise
    bandwidth: Optional[Tuple[Tuple[int, ...], ...]] = None
    #: shared inter-node bottleneck link, bytes/ns (0 = uncontended)
    bottleneck_bw: int = 0
    #: the *native* cross-node link bandwidth this machine was defined
    #: with, recorded by :meth:`with_bandwidth` so rescaled variants know
    #: how starved their fabric is (0 = the current matrix is native)
    native_bw: int = 0

    def __post_init__(self):
        assert 1 <= self.n_sockets <= DMAX, \
            f"{self.name}: n_sockets must be in [1, {DMAX}]"
        assert self.cores_per_socket >= 1, self.name
        d = self.dist
        assert len(d) == self.n_sockets and \
            all(len(r) == self.n_sockets for r in d), \
            f"{self.name}: dist must be {self.n_sockets}-square"
        for i in range(self.n_sockets):
            for j in range(self.n_sockets):
                assert int(d[i][j]) > 0, f"{self.name}: dist[{i}][{j}] <= 0"
                assert d[i][j] == d[j][i], \
                    f"{self.name}: dist must be symmetric at ({i},{j})"
                if i != j:
                    assert d[i][j] > d[i][i], \
                        f"{self.name}: off-diagonal dist[{i}][{j}] must " \
                        "exceed the intra-socket diagonal"
        assert self.n_nodes >= 1 and self.n_sockets % self.n_nodes == 0, \
            f"{self.name}: n_nodes must divide n_sockets"
        if self.is_cluster:
            assert self.bandwidth is not None, \
                f"{self.name}: cluster topologies need a bandwidth matrix"
            assert self.bottleneck_bw >= 0, self.name
        if self.bandwidth is not None:
            b = self.bandwidth
            assert len(b) == self.n_sockets and \
                all(len(r) == self.n_sockets for r in b), \
                f"{self.name}: bandwidth must be {self.n_sockets}-square"
            for i in range(self.n_sockets):
                for j in range(self.n_sockets):
                    assert int(b[i][j]) > 0, \
                        f"{self.name}: bandwidth[{i}][{j}] <= 0"
                    assert b[i][j] == b[j][i], \
                        f"{self.name}: bandwidth must be symmetric at " \
                        f"({i},{j})"

    # --- derived sizes ---
    @property
    def natural_workers(self) -> int:
        """The modeled machine's core count (benchmarks' full-scale W)."""
        return self.n_sockets * self.cores_per_socket

    @property
    def is_cluster(self) -> bool:
        """Multi-node machine: payload pricing + bottleneck link active."""
        return self.n_nodes > 1

    @property
    def sockets_per_node(self) -> int:
        return self.n_sockets // self.n_nodes

    def node_of_socket(self, s: int) -> int:
        """Node id of socket ``s`` (contiguous index blocks)."""
        return s // self.sockets_per_node

    def zone_size_for(self, n_workers: int) -> int:
        """Workers per socket when ``n_workers`` spread over the sockets —
        the same block arithmetic the flat model used for zones."""
        return max(n_workers // self.n_sockets, 1)

    @property
    def cross_node_bw(self) -> int:
        """The cross-node fabric bandwidth (max over cross-node links) —
        the reference :meth:`with_bandwidth` starves against."""
        if not self.is_cluster or self.bandwidth is None:
            return 0
        spn = self.sockets_per_node
        return max(int(self.bandwidth[i][j])
                   for i in range(self.n_sockets)
                   for j in range(self.n_sockets) if i // spn != j // spn)

    @property
    def bw_scale(self) -> float:
        """Cross-node fabric bandwidth relative to native, in (0, 1] —
        1.0 unless :meth:`with_bandwidth` starved the fabric.  Steers the
        victim policy's cross-node stratum (see ``dlb.pick_victim``): a
        half-starved fabric halves the cross-node steal probability."""
        if not self.is_cluster or not self.native_bw:
            return 1.0
        return min(1.0, self.cross_node_bw / self.native_bw)

    # --- identity (cache keys, plan sort, artifacts) ---
    def cache_key(self) -> dict:
        """JSON-able identity for the result-cache key: everything results
        depend on — the matrix, socket count, and flat flag — and nothing
        they don't (the *name* is presentation, like a graph's).  Cluster
        fields join the key only on cluster topologies, so every
        pre-cluster key (and with it the warm cache) is unchanged."""
        key = dict(n_sockets=self.n_sockets,
                   dist=[list(r) for r in self.dist],
                   flat=bool(self.is_flat))
        if self.is_cluster:
            key.update(n_nodes=self.n_nodes,
                       bandwidth=[list(r) for r in self.bandwidth],
                       bottleneck_bw=int(self.bottleneck_bw),
                       bw_scale=repr(float(self.bw_scale)))
        return key

    @property
    def sort_key(self) -> str:
        """Stable string for plan-order clustering (None sorts first as '')."""
        return f"{self.n_sockets:02d}:{self.name}:{self.dist}"

    def asdict(self) -> dict:
        d = dict(name=self.name, n_sockets=self.n_sockets,
                 cores_per_socket=self.cores_per_socket,
                 dist=[list(r) for r in self.dist],
                 is_flat=bool(self.is_flat))
        if self.is_cluster:
            d.update(n_nodes=self.n_nodes,
                     bandwidth=[list(r) for r in self.bandwidth],
                     bottleneck_bw=int(self.bottleneck_bw),
                     native_bw=int(self.native_bw))
        return d

    # --- tensor view ---
    def arrays(self, device="cpu") -> TopoArrays:
        """Lift to the ``(DMAX, DMAX)``-padded tensors on ``device``.  Padding
        rows/cols repeat the largest distance; they are unreachable (domain
        ids clip to ``n_domains - 1``) so the fill never matters."""
        fill = max(max(r) for r in self.dist)
        d = np.full((DMAX, DMAX), fill, np.int32)
        d[:self.n_sockets, :self.n_sockets] = np.asarray(self.dist, np.int32)
        node = np.zeros(DMAX, np.int32)
        node[:self.n_sockets] = [self.node_of_socket(s)
                                 for s in range(self.n_sockets)]
        # bandwidth padding fills with 1 byte/ns (slowest plausible link);
        # like the distance padding it is unreachable.  Non-cluster
        # machines get all-ones: never read (cluster=False zeroes every
        # payload term) but divisions stay well-defined.
        b = np.ones((DMAX, DMAX), np.int32)
        if self.bandwidth is not None:
            b[:self.n_sockets, :self.n_sockets] = np.asarray(
                self.bandwidth, np.int32)
        return _topo_arrays(self.n_sockets, d, self.is_flat, node, b,
                            self.is_cluster, max(self.bottleneck_bw, 1),
                            self.bw_scale, device)

    # --- constructors ---
    @classmethod
    def flat(cls, n_zones: int, name: Optional[str] = None
             ) -> "MachineTopology":
        """The degenerate topology mirroring the flat model's ``n_zones``
        zone grid — bitwise identical to running with no topology at all
        (tests/test_topology.py asserts it)."""
        return cls(name=name or f"flat{n_zones}", n_sockets=n_zones,
                   cores_per_socket=1, dist=_legacy_matrix(n_zones),
                   is_flat=True)

    def with_bandwidth(self, b: int) -> "MachineTopology":
        """The bandwidth sweep knob: this machine with every *cross-node*
        link (and the shared bottleneck) set to ``b`` bytes/ns.  Intra-node
        links keep their bandwidth — the knob models the inter-node fabric
        only.  The original fabric bandwidth is recorded as ``native_bw``
        so the starved machine's ``bw_scale`` (and with it the victim
        policy's cross-node stratum) reflects how far below native it
        runs; chained calls keep the first machine's reference.  No-op
        data-wise on single-node machines (still renamed, so sweep rows
        stay distinguishable)."""
        assert b >= 1, b
        spn = self.sockets_per_node
        base = (self.bandwidth if self.bandwidth is not None else
                tuple(tuple(1 for _ in range(self.n_sockets))
                      for _ in range(self.n_sockets)))
        bw = tuple(tuple(int(b) if i // spn != j // spn else int(base[i][j])
                         for j in range(self.n_sockets))
                   for i in range(self.n_sockets))
        return dataclasses.replace(
            self, name=f"{self.name}@bw{b}", bandwidth=bw,
            bottleneck_bw=(int(b) if self.is_cluster else self.bottleneck_bw),
            native_bw=(self.native_bw or self.cross_node_bw))


#: TopoArrays for cases built without a topology: the flat model.  The
#: matrix content is never read on the flat path (consumers use the legacy
#: CostModel constants directly), only the shape must be right.
def degenerate_arrays(device="cpu") -> TopoArrays:
    return _topo_arrays(1, np.full((DMAX, DMAX), DEFAULT_COSTS.c_numa,
                                   np.int32),
                        True, np.zeros(DMAX, np.int32),
                        np.ones((DMAX, DMAX), np.int32), False, 1, 1.0,
                        device)


def _topo_arrays(n_domains, dist, flat, node, bw, cluster, bneck_bw,
                 bw_scale, device) -> TopoArrays:
    def i32(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=device)

    return TopoArrays(n_domains=i32(n_domains), dist=i32(dist),
                      flat=torch.tensor(bool(flat), device=device),
                      node=i32(node), bw=i32(bw),
                      cluster=torch.tensor(bool(cluster), device=device),
                      bneck_bw=i32(bneck_bw),
                      bw_scale=torch.tensor(bw_scale, dtype=torch.float32,
                                            device=device))


def _cluster_matrices(n_nodes: int, sockets_per_node: int,
                      d_node: int = 500, bw_intra: int = 64,
                      bw_node: int = 16):
    """(dist, bandwidth) for a symmetric cluster: 30 ns intra-socket /
    100 ns cross-socket / ``d_node`` ns cross-node latency; 128 bytes/ns
    intra-socket, ``bw_intra`` cross-socket, ``bw_node`` cross-node."""
    n = n_nodes * sockets_per_node
    dist, bw = [], []
    for i in range(n):
        dr, br = [], []
        for j in range(n):
            if i == j:
                dr.append(30), br.append(128)
            elif i // sockets_per_node == j // sockets_per_node:
                dr.append(100), br.append(bw_intra)
            else:
                dr.append(d_node), br.append(bw_node)
        dist.append(tuple(dr)), bw.append(tuple(br))
    return tuple(dist), tuple(bw)


_TWO_NODE = _cluster_matrices(2, 2)
_RACK = _cluster_matrices(4, 2)

#: canned presets matching the paper's evaluation machines (§V) plus the
#: cluster tier above them: a single-socket workstation, a dual-socket
#: Skylake-SP-class node, a quad-socket node where the interconnect is two
#: hops between far socket pairs, and two multi-node machines (a two-node
#: pair and a four-node rack of dual-socket hosts) whose cross-node links
#: carry both a latency and a bandwidth, sharing one bottleneck uplink.
#: Distances follow the cost model's published-figure calibration
#: (c_zone=30 intra-socket, c_numa=100 one QPI/UPI hop, 160 two hops,
#: 500 a network round-trip).
PRESETS = {
    "uds": MachineTopology(
        name="uds", n_sockets=1, cores_per_socket=48,
        dist=((30,),)),
    "dual_socket_24": MachineTopology(
        name="dual_socket_24", n_sockets=2, cores_per_socket=12,
        dist=((30, 100),
              (100, 30))),
    "quad_socket_48": MachineTopology(
        name="quad_socket_48", n_sockets=4, cores_per_socket=12,
        dist=((30, 100, 160, 160),
              (100, 30, 160, 160),
              (160, 160, 30, 100),
              (160, 160, 100, 30))),
    # two dual-socket hosts over one network link (2 nodes × 2 × 24 cores)
    "two_node_2x24": MachineTopology(
        name="two_node_2x24", n_sockets=4, cores_per_socket=24,
        n_nodes=2, dist=_TWO_NODE[0], bandwidth=_TWO_NODE[1],
        bottleneck_bw=32),
    # a rack of four dual-socket hosts sharing one uplink (4 × 2 × 24)
    "rack_4x2x24": MachineTopology(
        name="rack_4x2x24", n_sockets=8, cores_per_socket=24,
        n_nodes=4, dist=_RACK[0], bandwidth=_RACK[1],
        bottleneck_bw=32),
}


def resolve(topology) -> Optional[MachineTopology]:
    """Normalize a ``topology=`` argument: ``None`` (flat model), a preset
    name from :data:`PRESETS`, or a :class:`MachineTopology` instance."""
    if topology is None or isinstance(topology, MachineTopology):
        return topology
    assert isinstance(topology, str), topology
    try:
        return PRESETS[topology]
    except KeyError:
        raise ValueError(
            f"unknown topology preset {topology!r}; available: "
            f"{sorted(PRESETS)} (or pass a MachineTopology)") from None


def label(topology) -> str:
    """Axis/row label: the preset name, or ``flat`` for no topology."""
    t = resolve(topology)
    return "flat" if t is None else t.name
