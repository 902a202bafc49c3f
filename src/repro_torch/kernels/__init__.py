"""Hand-written CUDA kernels for Hopper (sources under ``csrc/``), each with
its plain PyTorch twin beside it."""
