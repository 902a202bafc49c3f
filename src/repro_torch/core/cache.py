"""Content-addressed on-disk result cache for the experiment service.

A simulated case is a pure function of (task graph, configuration, cost
model, simulator code).  The cache keys on exactly that content — a SHA-256
over the graph's arrays, every ``CaseSpec`` knob, the ``SimConfig`` fields
that can change results, and a code-version tag — so overlapping grids
re-use results across processes and runs.  Keys exclude what results
are provably independent of: padding widths, chunking, execution strategy,
the step backend, the device, and the graph's *name*.

The keys and the entry format are the JAX package's (``repro.core.cache``)
byte for byte: for the same graph, ``CaseSpec`` and ``SimConfig`` both
packages compute the same digest, and an entry either package wrote is a
hit in the other.  Entries live as plain JSON under
``<root>/<key[:2]>/<key>.json`` (root: ``experiments/cache``, or
``REPRO_CACHE_DIR``), one file per case, written atomically.  The JAX
package's maintenance commands (``stats``, ``clear``) work on the same
store and are not repeated here.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from typing import Optional

import numpy as np

#: the simulator's code-version tag; equal to the JAX package's, because
#: the port's results are bitwise the same (bump both together)
CODE_VERSION = "cluster-tier-v4"

DEFAULT_ROOT = os.path.join("experiments", "cache")

#: record fields every entry must carry (see sweep.py's assembly)
RECORD_FIELDS = ("clock_max", "counters", "n_done", "overflow", "step_i")


def graph_digest(graph) -> str:
    """Content hash of a TaskGraph: its five arrays plus mem_bound (and the
    per-task payload sizes, when the graph carries any)."""
    d = getattr(graph, "_content_digest", None)
    if d is not None:
        return d
    h = hashlib.sha256()
    for a in (graph.dur, graph.first_child, graph.n_children, graph.notify,
              graph.join_dep):
        h.update(np.ascontiguousarray(np.asarray(a, np.int64)).tobytes())
    # the engine quantizes mem_bound to 3 decimals (sweep.py)
    h.update(repr(round(float(graph.mem_bound), 3)).encode())
    pay = getattr(graph, "payload", None)
    if pay is not None and np.asarray(pay).any():
        h.update(b"payload")
        h.update(np.ascontiguousarray(np.asarray(pay, np.int64)).tobytes())
    d = h.hexdigest()
    try:
        graph._content_digest = d   # memoize; graphs are immutable in use
    except Exception:
        pass
    return d


def case_key(gdigest: str, spec, cfg) -> str:
    """Cache key for one (graph, CaseSpec, SimConfig) triple.

    ``zone_size`` (not ``n_zones``) enters the key because it is what the
    simulator consumes; ``cfg.n_workers`` does not (the engine runs every
    case at its own worker count).  A topology enters as its structural
    identity and only when one is set; the cluster tier's ``p_local_node``
    only on cluster machines; an arrival process only when one is set.
    """
    fields = dict(
        v=CODE_VERSION,
        graph=gdigest,
        queue=spec.spec.queue, barrier=spec.spec.barrier,
        balance=spec.spec.balance,
        n_workers=spec.n_workers, zone_size=spec.zone_size,
        seed=spec.seed, n_victim=spec.n_victim, n_steal=spec.n_steal,
        t_interval=spec.t_interval, p_local=repr(float(spec.p_local)),
        queue_cap=cfg.queue_cap, stack_cap=cfg.stack_cap,
        max_steps=cfg.max_steps,
        costs={k: repr(v) for k, v in
               sorted(dataclasses.asdict(cfg.costs).items())},
    )
    topo = spec.topology
    if topo is not None:
        fields["topology"] = topo.cache_key()
        if topo.is_cluster:
            fields["p_local_node"] = repr(float(spec.p_local_node))
    if spec.arrivals is not None:
        fields["arrivals"] = spec.arrivals.cache_key()
    blob = json.dumps(fields, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()


class ResultCache:
    """Persistent per-case result store with hit/miss accounting."""

    def __init__(self, root: Optional[str] = None):
        self.root = str(root or os.environ.get("REPRO_CACHE_DIR",
                                               DEFAULT_ROOT))
        self.hits = 0
        self.misses = 0

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key[:2], key + ".json")

    def get(self, key: str, required_counters=()) -> Optional[dict]:
        """Fetch an entry; a record missing a field or a counter the
        engine will read is a miss, not a hit."""
        try:
            with open(self._path(key)) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            self.misses += 1
            return None
        if (not all(k in rec for k in RECORD_FIELDS)
                or not all(n in rec["counters"] for n in required_counters)):
            self.misses += 1
            return None
        self.hits += 1
        return rec

    def put(self, key: str, record: dict) -> None:
        assert all(k in record for k in RECORD_FIELDS), record.keys()
        record = dict(record, code_version=CODE_VERSION)
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(record, f)
            os.replace(tmp, path)   # atomic: concurrent writers both win
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise


def resolve(cache) -> Optional[ResultCache]:
    """Normalize ``run_cases``' ``cache=`` argument: ``None``/``False`` →
    no caching, ``True`` → the default on-disk store, a
    :class:`ResultCache` → itself."""
    if cache is None or cache is False:
        return None
    if cache is True:
        return ResultCache()
    assert isinstance(cache, ResultCache), cache
    return cache
