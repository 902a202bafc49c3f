"""Composable runtime configuration: queue × barrier × balance.

The paper's three contributions — XQueue, the distributed tree barrier, and
the NUMA-aware balancing policies — are orthogonal runtime components, but
the historical public API hard-coded them as a closed five-rung ablation
ladder (``MODES``/``mode_id``).  :class:`RuntimeSpec` decomposes that ladder
into three independent axes, turning the 5-point ladder into a full
2 × 2 × 3 = 12-point ablation lattice:

====================  =======================================================
axis                  values
====================  =======================================================
``queue``             ``locked_global`` — GOMP's single global priority
                      queue behind one task lock (malloc + priority-queue op
                      in the critical path, every push/pop serializes);
                      ``xqueue`` — the paper's per-pair SPSC lock-less queues
                      (§II-B).
``barrier``           ``centralized_count`` — GNU's centralized barrier plus
                      a *globally shared* atomic task count updated on every
                      create/finish (contended; with the ``locked_global``
                      queue the count update piggybacks on the already-held
                      task lock, so only ``xqueue`` runtimes pay it
                      separately); ``tree`` — the paper's hybrid lock-free /
                      lock-less distributed tree barrier, no global count at
                      all (§III-B).
``balance``           ``static_rr`` — static round-robin placement only;
                      ``na_rp`` — NUMA-aware Redirect Push (Alg. 3);
                      ``na_ws`` — NUMA-aware Work Stealing (Alg. 4).
====================  =======================================================

The five legacy mode strings are canned points on this lattice
(:data:`MODE_SPECS`, :meth:`RuntimeSpec.from_mode`) and reproduce the
pre-decomposition results bitwise (tests/test_golden_modes.py).  The seven
remaining combinations are the off-ladder points the paper could not
isolate — e.g. the locked global queue under the tree barrier, or NA-WS
under the centralized atomic count (benchmarks/ablation_lattice.py sweeps
all twelve and attributes speedup per axis).

Each axis value also has a stable integer id (its index in the axis tuple)
— that id is what the simulator carries as a 0-dim int32 tensor (see
``state.SweepCase``), so axis selection is mask arithmetic on the device.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Iterable, Tuple

#: axis value tuples — index order defines the integer axis ids
QUEUES = ("locked_global", "xqueue")
BARRIERS = ("centralized_count", "tree")
BALANCERS = ("static_rr", "na_rp", "na_ws")

QUEUE_ID = {q: i for i, q in enumerate(QUEUES)}
BARRIER_ID = {b: i for i, b in enumerate(BARRIERS)}
BALANCE_ID = {b: i for i, b in enumerate(BALANCERS)}

#: axis name -> value tuple (the full lattice definition in one place)
AXES = dict(queue=QUEUES, barrier=BARRIERS, balance=BALANCERS)

#: balancers whose DLB knobs (n_victim/n_steal/t_interval/p_local) are live
DLB_BALANCERS = ("na_rp", "na_ws")


@functools.total_ordering
@dataclasses.dataclass(frozen=True)
class RuntimeSpec:
    """One point on the queue × barrier × balance lattice.

    The default is the paper's SLB baseline (XQueue + tree barrier + static
    round-robin), i.e. the legacy ``"xgomptb"`` mode.  Ordering is
    lexicographic on the axis *ids* (not the value strings), so sorted
    sequences of specs are deterministic, group the lattice axis-major, and
    put each axis's baseline value first.
    """
    queue: str = "xqueue"
    barrier: str = "tree"
    balance: str = "static_rr"

    def __post_init__(self):
        assert self.queue in QUEUES, (self.queue, QUEUES)
        assert self.barrier in BARRIERS, (self.barrier, BARRIERS)
        assert self.balance in BALANCERS, (self.balance, BALANCERS)

    def __lt__(self, other: "RuntimeSpec") -> bool:
        if not isinstance(other, RuntimeSpec):
            return NotImplemented
        return self.axis_ids < other.axis_ids

    @property
    def axis_ids(self) -> Tuple[int, int, int]:
        return (self.queue_id, self.barrier_id, self.balance_id)

    # --- integer-id views (what the simulator consumes) ---
    @property
    def queue_id(self) -> int:
        return QUEUE_ID[self.queue]

    @property
    def barrier_id(self) -> int:
        return BARRIER_ID[self.barrier]

    @property
    def balance_id(self) -> int:
        return BALANCE_ID[self.balance]

    @property
    def axes(self) -> Tuple[str, str, str]:
        return (self.queue, self.barrier, self.balance)

    # --- naming ---
    @property
    def slug(self) -> str:
        """Filesystem/label-safe name, e.g. ``xqueue-tree-na_ws``.

        Axis values never contain ``-``, so the slug parses back uniquely.
        """
        q = "locked" if self.queue == "locked_global" else self.queue
        b = "cent" if self.barrier == "centralized_count" else self.barrier
        return f"{q}-{b}-{self.balance}"

    @property
    def mode(self) -> str | None:
        """The legacy five-rung mode name, or None for off-ladder specs."""
        return _SPEC_MODES.get(self)

    @property
    def label(self) -> str:
        """Legacy mode name when on-ladder, else the slug."""
        return self.mode or self.slug

    @property
    def is_dlb(self) -> bool:
        return self.balance in DLB_BALANCERS

    def asdict(self) -> dict:
        return dict(queue=self.queue, barrier=self.barrier,
                    balance=self.balance)

    # --- construction helpers ---
    @classmethod
    def from_mode(cls, mode: str) -> "RuntimeSpec":
        """Map a legacy five-rung mode name onto the lattice."""
        try:
            return MODE_SPECS[mode]
        except KeyError:
            raise ValueError(
                f"unknown legacy mode {mode!r}; expected one of "
                f"{tuple(MODE_SPECS)} (or build a RuntimeSpec directly)"
            ) from None

    @classmethod
    def from_slug(cls, slug: str) -> "RuntimeSpec":
        by_slug = {s.slug: s for s in LATTICE}
        try:
            return by_slug[slug]
        except KeyError:
            raise ValueError(f"unknown spec slug {slug!r}; expected one of "
                             f"{sorted(by_slug)}") from None

    @classmethod
    def coerce(cls, value: "RuntimeSpec | str") -> "RuntimeSpec":
        """Accept a RuntimeSpec, a legacy mode name, or a slug — silently.

        Internal plumbing helper; the *deprecation* for legacy mode strings
        fires at the public entry points (see :func:`resolve_spec`).
        """
        if isinstance(value, cls):
            return value
        assert isinstance(value, str), value
        if value in MODE_SPECS:
            return MODE_SPECS[value]
        return cls.from_slug(value)


#: legacy mode name -> lattice point (the paper's five-rung ladder)
MODE_SPECS = {
    "gomp": RuntimeSpec("locked_global", "centralized_count", "static_rr"),
    "xgomp": RuntimeSpec("xqueue", "centralized_count", "static_rr"),
    "xgomptb": RuntimeSpec("xqueue", "tree", "static_rr"),
    "na_rp": RuntimeSpec("xqueue", "tree", "na_rp"),
    "na_ws": RuntimeSpec("xqueue", "tree", "na_ws"),
}
_SPEC_MODES = {s: m for m, s in MODE_SPECS.items()}

#: every lattice point, axis-major (queue, then barrier, then balance)
LATTICE: Tuple[RuntimeSpec, ...] = tuple(
    RuntimeSpec(q, b, bal) for q in QUEUES for b in BARRIERS
    for bal in BALANCERS)

#: lattice points the legacy ladder could not express
OFF_LADDER: Tuple[RuntimeSpec, ...] = tuple(
    s for s in LATTICE if s not in _SPEC_MODES)

#: the paper's SLB baseline (XQueue + tree barrier + static round-robin)
SLB_SPEC = RuntimeSpec()


def dlb_spec(balance: str) -> RuntimeSpec:
    """The paper's DLB runtime for ``balance``: XQueue + tree + balancer."""
    assert balance in DLB_BALANCERS, (balance, DLB_BALANCERS)
    return RuntimeSpec(balance=balance)


def resolve_spec(spec: "RuntimeSpec | str | None",
                 mode: "str | RuntimeSpec | None",
                 *, default: RuntimeSpec | None = None,
                 where: str = "this call", stacklevel: int = 3
                 ) -> RuntimeSpec:
    """Resolve the ``spec=`` / legacy ``mode=`` argument pair.

    ``spec`` is the canonical argument (a :class:`RuntimeSpec`, or a slug /
    mode string, accepted silently).  ``mode`` is the deprecated legacy
    argument: passing a mode *string* through it emits a
    ``DeprecationWarning`` naming the replacement spec.  Passing both is an
    error; passing neither returns ``default`` (the SLB baseline when
    unset).
    """
    if spec is not None and mode is not None:
        raise TypeError("pass either spec= or (deprecated) mode= to "
                        f"{where}, not both")
    if spec is not None:
        return RuntimeSpec.coerce(spec)
    if mode is None:
        return default if default is not None else RuntimeSpec()
    if isinstance(mode, RuntimeSpec):
        return mode
    resolved = RuntimeSpec.from_mode(mode)
    warnings.warn(
        f"string mode={mode!r} in {where} is deprecated; pass "
        f"spec=RuntimeSpec(queue={resolved.queue!r}, "
        f"barrier={resolved.barrier!r}, balance={resolved.balance!r}) "
        f"(or RuntimeSpec.from_mode({mode!r})) instead",
        DeprecationWarning, stacklevel=stacklevel)
    return resolved


def spec_product(queues: Iterable[str] = ("xqueue",),
                 barriers: Iterable[str] = ("tree",),
                 balancers: Iterable[str] = ("static_rr",)
                 ) -> Tuple[RuntimeSpec, ...]:
    """Cartesian spec lattice, axis-major — ``run_grid``'s spec axes."""
    return tuple(RuntimeSpec(q, b, bal) for q in queues for b in barriers
                 for bal in balancers)
