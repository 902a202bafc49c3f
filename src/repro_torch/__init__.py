"""PyTorch/CUDA port of the scheduler simulator and of the model stack's
serving and training paths (the JAX package ``repro`` is the reference it
is held against).

It imports ``torch`` and numpy, never ``jax`` and nothing of ``repro``.
Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (``--device cpu`` for ``launch.serve`` and
``launch.train``).  See :mod:`repro_torch.core`,
:mod:`repro_torch.launch.serve` and :mod:`repro_torch.launch.train`.
"""
