"""Where an analysis of a traced call learns what its dispatch mode cannot
count: the port's counterpart of the JAX analyzer's fusion and while-loop
handling (:mod:`repro_torch.launch.hlo_analysis`).

Two things on the model path escape a count of the ATen ops a call
dispatches:

* the three model kernels (flash attention, RWKV6, the MoE dispatch)
  launch through ``ctypes``, so the dispatcher never sees their work, and
  a fake tensor cannot launch them.  While an analysis counts,
  :mod:`repro_torch.kernels.ops` records each call's cost by formula
  (``ACTIVE.record``) and returns its outputs (the kernel's, or empty
  tensors of its shapes on fake inputs);
* the step loops of :mod:`repro_torch.kernels.ref` run one Python step per
  sequence position, so a walk of a 32k sequence under fake tensors would
  take millions of dispatches.  While an analysis counts, each such loop
  runs through ``ACTIVE.loop``: a few short prefixes are counted and the
  cost is extrapolated to the whole length (the JAX analyzer multiplies a
  while body by its trip count).

``ACTIVE`` is None unless an analysis runs; then those call sites test
this one module global and do what they always did.
"""

from __future__ import annotations

#: the analysis in progress (``launch.hlo_analysis.Analysis``), or None
ACTIVE = None


def counting():
    """The active analysis when it counts (not paused), else None."""
    a = ACTIVE
    return a if a is not None and a.counting else None
