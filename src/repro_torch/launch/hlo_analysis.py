"""Roofline terms of a traced call: the port of the JAX package's
``launch/hlo_analysis.py``, over the ATen ops a call dispatches in place of
post-optimization HLO text.

The port has no HLO: its steps are eager PyTorch over DTensors.  So
:func:`analyze` runs a call under a ``TorchDispatchMode`` that sees every
ATen op it dispatches, on real tensors or on fake ones (``FakeTensorMode``,
over a fake process group of the mesh's size: what the dry-run traces),
and counts the same either way.  There is no text to parse, so the JAX
module's ``Instr``, ``parse_computations`` and ``_trip_count`` have no
counterpart.

Reported per rank (the traced call *is* one rank's program), with the JAX
module's conventions:

  flops       2 * |out| * contracted size of every matmul-like op (mm,
              bmm, addmm, baddbmm, convolution and its backward: the
              formulas of ``torch.utils.flop_counter``), plus the three
              model kernels by formula; elementwise flops are not counted
  hbm_bytes   input plus output bytes of every op that is not a view (nor
              an allocation without a write, nor a wait): in eager mode
              each op is a launch that reads its inputs and writes its
              outputs, the port's counterpart of XLA's fusion boundary;
              an in-place op counts its target as read and written; a
              copy between devices (a host value to the card: the
              learning rate, a batch) crosses the host link, and the
              same step on the CPU makes no such copy, so its bytes are
              not counted
  coll_bytes  operand bytes of every ``c10d_functional`` / ``c10d``
              collective, per rank, with no ring factor, also by op in
              ``coll_by_op`` (``all_gather_into_tensor``, ``all_reduce``,
              ``reduce_scatter_tensor``, ``all_to_all_single``, ...)

Two things escape such a count, and enter through
:mod:`repro_torch.kernels.trace_hooks`:

* the model kernels (flash attention, RWKV6, the MoE dispatch) launch
  through ``ctypes``: :mod:`repro_torch.kernels.ops` records their cost by
  formula (the bounds of PERF.md's kernel table) and runs them with the
  count paused;
* the step loops of :mod:`repro_torch.kernels.ref` (``_rwkv6_steps``,
  ``rwkv6_backward``, ``_ssm_steps`` / ``ref.SSMScan``, ``ssm_backward``):
  the JAX analyzer multiplies a while body by its trip count.  Here each
  such loop of T steps is counted on its first 2, 3, 4 and B + 2 steps
  (B the loop's block of 64 steps), the cost ``a + b T + c ceil(T / B)``
  fitted through 2, 3 and B + 2 steps and checked at 4, and that cost
  added; then the loop runs with the count paused (on fake inputs its
  outputs are empty tensors of their full shapes).  A loop whose probes do
  not fit is walked step by step, counted, and counted in
  ``unknown_trip_loops``.  A loop of at most B + 2 steps is walked.

Memory: the live bytes of the storages the call allocates (fake or real),
tracked by weak references as ops create them, on top of the arguments'
storages: ``arg_bytes``, the peak of the new ones ``temp_bytes +
out_bytes`` (``out_bytes`` those the result holds) and their sum
``peak_bytes``, the record's ``memory_per_device_bytes``.

``by_op`` tallies each ATen op's calls, flops and bytes (the model
kernels' are in ``kernels``).  ``flop_counter_flops`` is what
``FlopCounterMode`` reports for the same call: every op of
``torch.utils.flop_counter.flop_registry``, the model kernels not
included (it stands where the JAX record has ``cost_analysis()``'s
flops).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from collections import defaultdict
from typing import Dict

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.kernels import trace_hooks

aten = torch.ops.aten

#: matmul-like ops whose products are the analysis's flops
MATMUL_OPS = (aten.mm, aten.addmm, aten.bmm, aten.baddbmm, aten.convolution,
              aten._convolution, aten.convolution_backward,
              aten.cudnn_convolution, aten.convolution_overrideable,
              aten._slow_conv2d_forward)

#: collective ops (by overload packet) -> (the key of ``coll_by_op``, the
#: index of the operand argument)
COLLECTIVES = {
    "_c10d_functional.all_gather_into_tensor": ("all_gather_into_tensor", 0),
    "_c10d_functional.all_gather_into_tensor_out":
        ("all_gather_into_tensor", 0),
    "_c10d_functional.all_gather_into_tensor_coalesced":
        ("all_gather_into_tensor", 0),
    "_c10d_functional.all_reduce": ("all_reduce", 0),
    "_c10d_functional.all_reduce_": ("all_reduce", 0),
    "_c10d_functional.all_reduce_coalesced": ("all_reduce", 0),
    "_c10d_functional.reduce_scatter_tensor": ("reduce_scatter_tensor", 0),
    "_c10d_functional.reduce_scatter_tensor_coalesced":
        ("reduce_scatter_tensor", 0),
    "_c10d_functional.all_to_all_single": ("all_to_all_single", 0),
    "_c10d_functional_autograd.all_to_all_single": ("all_to_all_single", 0),
    "_c10d_functional.broadcast": ("broadcast", 0),
    "c10d.allreduce_": ("all_reduce", 0),
    "c10d.allreduce_coalesced_": ("all_reduce", 0),
    "c10d._allgather_base_": ("all_gather_into_tensor", 1),
    "c10d.allgather_into_tensor_coalesced_": ("all_gather_into_tensor", 1),
    "c10d.allgather_": ("all_gather", 1),
    "c10d._reduce_scatter_base_": ("reduce_scatter_tensor", 1),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce_scatter_tensor", 1),
    "c10d.reduce_scatter_": ("reduce_scatter", 1),
    "c10d.alltoall_base_": ("all_to_all_single", 1),
    "c10d.alltoall_": ("all_to_all", 1),
    "c10d.broadcast_": ("broadcast", 0),
    "c10d.scatter_": ("scatter", 1),
    "c10d.gather_": ("gather", 1),
    "c10d.reduce_": ("reduce", 0),
}

#: ops that move no data: allocations without a write, waits, and
#: ``_unsafe_view`` (a view that autograd does not track as one)
NO_DATA = {"aten.empty", "aten.empty_strided", "aten.empty_like",
           "aten.new_empty", "aten.new_empty_strided", "aten.lift_fresh",
           "aten._local_scalar_dense", "aten._unsafe_view",
           "_c10d_functional.wait_tensor",
           "prim.device"}

#: the steps of a loop's probes inside its first block: 2 and 3 fit the
#: cost of a step, 4 checks the fit (a probe of B + 2 steps, B the block,
#: fits the cost of a block)
PROBES = (2, 3, 4)


@dataclasses.dataclass
class HloCost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_op: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    unknown_trip_loops: int = 0
    #: the sum of ``torch.utils.flop_counter``'s formulas (FlopCounterMode)
    flop_counter_flops: float = 0.0
    #: per model kernel: calls, flops and bytes recorded by formula
    kernels: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    arg_bytes: int = 0
    temp_bytes: int = 0
    out_bytes: int = 0
    peak_bytes: int = 0
    #: per ATen op (overload packet): calls, flops and bytes
    by_op: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)

    def merged(self, other: "HloCost", mult: float) -> "HloCost":
        """This cost plus ``mult`` times ``other``'s counts; memory is the
        larger of the two (a repeated body allocates no more)."""
        out = HloCost(self.flops + other.flops * mult,
                      self.hbm_bytes + other.hbm_bytes * mult,
                      self.coll_bytes + other.coll_bytes * mult,
                      defaultdict(float, self.coll_by_op),
                      self.unknown_trip_loops + other.unknown_trip_loops,
                      self.flop_counter_flops
                      + other.flop_counter_flops * mult,
                      {k: dict(v) for k, v in self.kernels.items()},
                      max(self.arg_bytes, other.arg_bytes),
                      max(self.temp_bytes, other.temp_bytes),
                      max(self.out_bytes, other.out_bytes),
                      max(self.peak_bytes, other.peak_bytes),
                      {k: dict(v) for k, v in self.by_op.items()})
        for k, v in other.coll_by_op.items():
            out.coll_by_op[k] += v * mult
        for mine, theirs in ((out.kernels, other.kernels),
                             (out.by_op, other.by_op)):
            for name, tally in theirs.items():
                acc = mine.setdefault(name, dict.fromkeys(tally, 0.0))
                for k, v in tally.items():
                    acc[k] += v * mult
        return out


def _combine(*terms) -> HloCost:
    """Σ coefficient × cost over ``(cost, coefficient)`` pairs."""
    out = HloCost()
    for cost, coef in terms:
        out = out.merged(dataclasses.replace(cost, unknown_trip_loops=0),
                         coef)
    return out


def _same_counts(a: HloCost, b: HloCost) -> bool:
    keys = set(a.coll_by_op) | set(b.coll_by_op)
    return (a.flops, a.hbm_bytes, a.coll_bytes, a.flop_counter_flops) == (
        b.flops, b.hbm_bytes, b.coll_bytes, b.flop_counter_flops) and all(
        a.coll_by_op.get(k, 0.0) == b.coll_by_op.get(k, 0.0) for k in keys)


_DEVICE = torch.ops.prim.device.default


def _flat_tensors(args, kwargs) -> list:
    """The tensors of an op's arguments (directly or in a list), but an
    ``out=`` argument."""
    out = []
    for x in list(args) + [v for k, v in kwargs.items() if k != "out"]:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(y for y in x if isinstance(y, torch.Tensor))
    return out


def _aliases(func) -> bool:
    """Whether an op's outputs alias its inputs (a view or an in-place
    op): it allocates nothing."""
    hit = _ALIASES.get(func)
    if hit is None:
        hit = _ALIASES[func] = func.is_view or any(
            r.alias_info is not None for r in func._schema.returns)
    return hit


_ALIASES: dict = {}


def _tensors(tree) -> list:
    """The plain tensors of a pytree (a DTensor's local tensor)."""
    out = []
    for x in tree_flatten(tree)[0]:
        if isinstance(x, torch.Tensor):
            local = getattr(x, "_local_tensor", None)
            out.append(x if local is None else local)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return None


class _Mode(TorchDispatchMode):
    """Hands every ATen op to the analysis; a DTensor op runs first (so
    its local ops and collectives come back here), as ``CommDebugMode``
    does."""

    def __init__(self, analysis: "Analysis"):
        super().__init__()
        self.analysis = analysis

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if func is _DEVICE or isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        self.analysis.observe(func, args, kwargs, out)
        return out


class Analysis:
    """The state of one :func:`analyze` call: the running counts, the
    storages it tracks, and the hooks of
    :mod:`repro_torch.kernels.trace_hooks`."""

    def __init__(self):
        from torch._subclasses.fake_tensor import FakeTensor

        self._fake_type = FakeTensor
        self.cost = HloCost()
        self._paused = 0
        self._known: set = set()          # the arguments' storages
        self._live: dict = {}             # storage key -> (weakref, bytes)
        self.live_bytes = 0
        self.peak_new = 0

    # -- the hooks ----------------------------------------------------------
    @property
    def counting(self) -> bool:
        return self._paused == 0

    @contextlib.contextmanager
    def paused(self):
        """Ops run inside are not counted (their storages still are)."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def is_fake(self, t) -> bool:
        return isinstance(t, self._fake_type)

    def empty_like(self, t):
        with self.paused():
            return torch.empty_like(t)

    def record(self, name: str, flops: float, nbytes: float) -> None:
        """One call of a model kernel, by formula."""
        self.cost.flops += flops
        self.cost.hbm_bytes += nbytes
        tally = self.cost.kernels.setdefault(
            name, {"calls": 0.0, "flops": 0.0, "bytes": 0.0})
        tally["calls"] += 1
        tally["flops"] += flops
        tally["bytes"] += nbytes

    def loop(self, T: int, block: int, part, full):
        """A step loop of ``T`` steps: ``part(n)`` runs its first ``n``,
        ``full()`` all of them (see the module docstring)."""
        if T <= block + 2:
            return full()
        probes, outs = {}, {}
        for n in PROBES + (block + 2,):
            before = self.cost
            self.cost = HloCost()
            outs[n] = part(n)
            probes[n] = self.cost
            self.cost = before
        c2, c3, c4, cb = (probes[n] for n in PROBES + (block + 2,))
        per_step = _combine((c3, 1), (c2, -1))
        per_block = _combine((cb, 1), (c2, -1), (per_step, -block))
        fixed = _combine((c2, 1), (per_step, -2), (per_block, -1))
        if not _same_counts(_combine((fixed, 1), (per_step, 4),
                                     (per_block, 1)), c4):
            self.cost.unknown_trip_loops += 1
            return full()
        self.cost = self.cost.merged(_combine(
            (fixed, 1), (per_step, T), (per_block, math.ceil(T / block))), 1)
        first = _tensors(outs[3])
        with self.paused():
            if first and self.is_fake(first[0]):
                return _full_outputs(outs[3], outs[4], T)
            return full()

    # -- the dispatch mode --------------------------------------------------
    def observe(self, func, args, kwargs, out) -> None:
        outs = ([out] if isinstance(out, torch.Tensor)
                else _flat_tensors(out if isinstance(out, (list, tuple))
                                   else (out,), {}))
        if not _aliases(func):
            for t in outs:
                st = _storage(t)
                if st is not None:
                    self._track(st)
        if not self.counting:
            return
        ins = _flat_tensors(args, kwargs)
        name = str(func.overloadpacket)
        c = self.cost
        tally = c.by_op.get(name)
        if tally is None:
            tally = c.by_op[name] = {"calls": 0.0, "flops": 0.0,
                                     "bytes": 0.0}
        tally["calls"] += 1
        coll = COLLECTIVES.get(name)
        if coll is not None:
            key, i = coll
            operand = _tensors(args[i]) if i < len(args) else []
            nb = sum(map(_nbytes, operand))
            c.coll_bytes += nb
            c.coll_by_op[key] += nb
        if name not in NO_DATA and not func.is_view \
                and not _crosses_devices(name, ins, outs):
            nb = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            c.hbm_bytes += nb
            tally["bytes"] += nb
        packet = func.overloadpacket
        formula = flop_counter.flop_registry.get(packet)
        if formula is not None:
            n = formula(*args, **kwargs, out_val=out)
            c.flop_counter_flops += n
            if packet in MATMUL_OPS:
                c.flops += n
                tally["flops"] += n

    # -- memory -------------------------------------------------------------
    def _track(self, st) -> None:
        key = st._cdata
        if key in self._known or key in self._live:
            return
        n = st.nbytes()

        def freed(_ref, key=key, n=n):
            if self._live.pop(key, None) is not None:
                self.live_bytes -= n

        self._live[key] = (weakref.ref(st, freed), n)
        self.live_bytes += n
        self.peak_new = max(self.peak_new, self.live_bytes)

    def hold_arguments(self, tree) -> int:
        """Mark the storages of ``tree`` as the arguments'; their bytes."""
        total = 0
        for t in _tensors(tree):
            st = _storage(t)
            if st is not None and st._cdata not in self._known:
                self._known.add(st._cdata)
                total += st.nbytes()
        return total

    def new_bytes_of(self, tree) -> int:
        """The bytes of the storages of ``tree`` that the call made."""
        seen, total = set(), 0
        for t in _tensors(tree):
            st = _storage(t)
            if st is not None and st._cdata in self._live \
                    and st._cdata not in seen:
                seen.add(st._cdata)
                total += self._live[st._cdata][1]
        return total


#: the copies whose operands may lie on two devices
COPIES = {"aten._to_copy", "aten.copy_", "aten.copy"}


def _crosses_devices(name: str, ins, outs) -> bool:
    """Whether the op ``name`` is a copy between two devices."""
    return name in COPIES and len({t.device for t in (*ins, *outs)}) > 1


def _full_outputs(out3, out4, T: int):
    """Empty tensors shaped as a loop's outputs over ``T`` steps, from its
    outputs over 3 and 4 steps: a dim that is 3 in the first and 4 in the
    second has T; each keeps the dims' order in memory of the 4-step
    output."""
    flat3, spec = tree_flatten(out3)
    flat4, _ = tree_flatten(out4)
    out = []
    for a, b in zip(flat3, flat4):
        if not isinstance(a, torch.Tensor):
            out.append(a)
            continue
        shape = [T if (x, y) == (3, 4) else x for x, y in zip(a.shape,
                                                               b.shape)]
        if any(x != y and (x, y) != (3, 4) for x, y in zip(a.shape,
                                                          b.shape)):
            raise ValueError(f"a loop output of shapes {tuple(a.shape)} "
                             f"and {tuple(b.shape)} does not scale")
        order = sorted(range(b.dim()), key=lambda d: (-b.stride(d), d))
        t = b.new_empty([shape[d] for d in order])
        out.append(t.permute([order.index(d) for d in range(b.dim())]))
    return tree_unflatten(out, spec)


def analyze(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), HloCost)``: the call's result and what it
    dispatched, per rank (see the module docstring).  The arguments'
    storages are ``arg_bytes``; one analysis runs at a time."""
    if trace_hooks.ACTIVE is not None:
        raise RuntimeError("an analysis is already running")
    a = Analysis()
    arg_bytes = a.hold_arguments((args, kwargs))
    trace_hooks.ACTIVE = a
    try:
        with _Mode(a):
            result = fn(*args, **kwargs)
    finally:
        trace_hooks.ACTIVE = None
    cost = a.cost
    cost.arg_bytes = arg_bytes
    cost.out_bytes = a.new_bytes_of(result)
    cost.temp_bytes = max(a.peak_new - cost.out_bytes, 0)
    cost.peak_bytes = arg_bytes + cost.temp_bytes + cost.out_bytes
    return result, cost
