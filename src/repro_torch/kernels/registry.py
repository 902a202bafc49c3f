"""The package's one registry of hand-written kernels, and how each is built
and bound.

Every CUDA source under ``csrc/`` is built and bound the same way:

* at first use, ``nvcc -gencode arch=compute_90a,code=sm_90a`` builds the
  source into its own shared library under
  ``build/repro_torch_kernels/<hash>/`` at the repository root, keyed by a
  hash of the source and the flags (:func:`build`);
* the library is loaded with ``ctypes``; every pointer
  (``Tensor.data_ptr()``) and the stream (:func:`stream`) pass as
  ``c_void_p``; kernels launch on the current stream;
* each C entry point returns ``cudaGetLastError()``, and the wrapper hands
  it to :func:`launched`, which raises if it is not 0 and otherwise adds
  one to the kernel's count in :data:`KERNELS`.  A missing ``nvcc`` or a
  failed build raises too.

A wrapper calls :func:`launched` where it launches its kernel and nowhere
else, so ``KERNELS[name].launches`` counts what ran on the card.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

#: build output root: ``build/`` at the repository root (git-ignored)
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


@dataclasses.dataclass
class Kernel:
    """One hand-written kernel: its name, the TPU kernel it replaces, and
    how many times its wrapper launched it."""
    name: str
    replaces: str
    launches: int = 0


#: every hand-written kernel of the package, with its launch count: the
#: queue kernels of :mod:`~repro_torch.kernels.sched_queue`, the fused step
#: of :mod:`~repro_torch.kernels.sched_step`, the attention forward of
#: :mod:`~repro_torch.kernels.flash_attention`, the RWKV6 recurrence of
#: :mod:`~repro_torch.kernels.rwkv6_scan` and the MoE dispatch of
#: :mod:`~repro_torch.kernels.moe_dispatch`
KERNELS = {k.name: k for k in (
    Kernel("ctr_add", "src/repro/kernels/sched_queue.py:54"),
    Kernel("push", "src/repro/kernels/sched_queue.py:108"),
    Kernel("pop_first", "src/repro/kernels/sched_queue.py:144"),
    Kernel("sched_step", "src/repro/kernels/sched_step.py:121"),
    Kernel("flash_attention", "src/repro/kernels/flash_attention.py:105"),
    Kernel("rwkv6_scan", "src/repro/kernels/rwkv6_scan.py:67"),
    Kernel("moe_dispatch", "src/repro/kernels/moe_dispatch.py:65"),
)}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    """``{kernel name: launches}`` as they stand."""
    return {name: k.launches for name, k in KERNELS.items()}


def _nvcc(source: Path) -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       f"{source.name}")


def build(source: Path) -> tuple[Path, str]:
    """Compile one CUDA source into its own shared library if this
    source/flag hash has none yet.  Returns ``(library path, compiler
    log)``; the log (ptxas's resource report among it) is kept beside the
    library as ``lib<stem>.log`` and read back when the library was already
    built, and a library without its log is built again."""
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_ROOT / digest / f"lib{source.stem}.so"
    log = lib.with_suffix(".log")
    if lib.exists() and log.exists():
        return lib, log.read_text()
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(source), *NVCC_FLAGS, "-o", str(tmp),
                           str(source)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name}:\n{proc.stderr}")
    text = proc.stdout + proc.stderr
    tmp_log = log.with_name(f"{log.name}.{os.getpid()}.tmp")
    tmp_log.write_text(text)
    os.replace(tmp_log, log)
    os.replace(tmp, lib)
    return lib, text


def launched(name: str, err: int) -> None:
    """Raise if the launch of kernel ``name`` returned CUDA error ``err``;
    otherwise count it."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error "
                           f"{err} ({torch.cuda.get_device_name()})")
    KERNELS[name].launches += 1


def stream(index: int | None = None) -> int:
    """The current stream of device ``index`` (default: the current
    device) as a raw ``cudaStream_t`` (an int, for a ``c_void_p``
    argument): the stream PyTorch's own ops on that device's tensors use.
    ``torch.cuda.current_stream()`` builds a Python ``Stream`` object a
    call; the raw handle costs less on the per-op path, where the host is
    the bound, and a wrapper that knows its tensors' device index skips
    the current-device lookup too."""
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)
