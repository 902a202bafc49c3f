"""PyTorch/CUDA port of the scheduler simulator and of the model stack's
dense serving path (the JAX package ``repro`` is the reference it is held
against).

It imports ``torch`` and numpy, never ``jax`` and nothing of ``repro``.
Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (``--device cpu`` for ``launch.serve``).  See
:mod:`repro_torch.core` and :mod:`repro_torch.launch.serve`.
"""
