"""PyTorch/CUDA port of the scheduler simulator (the JAX package ``repro``
is the reference it is held against).

It imports ``torch`` and numpy, never ``jax`` and nothing of ``repro``.
Entry points run on the CUDA device unless the caller passes
``device="cpu"``.  See :mod:`repro_torch.core`.
"""
