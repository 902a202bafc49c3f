"""Public attention API with implementation dispatch (the port of the JAX
package's ``kernels/ops.py``, its two attention entry points).

Models call these wrappers.  ``set_impl`` forces a path:

  set_impl("ref")     always the plain PyTorch twin (``kernels/ref.py``)
  set_impl("cuda")    always the CUDA kernel; a CPU tensor raises
  set_impl(None)      by the tensor (default): a CUDA tensor launches the
                      kernel, a CPU tensor takes the plain twin

``decode_attention`` has no kernel in either package: it is the plain op.
"""

from __future__ import annotations

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

IMPLS = (None, "ref", "cuda")
_FORCE = None


def set_impl(impl) -> None:
    global _FORCE
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, not {impl!r}")
    _FORCE = impl


def flash_attention(q, k, v, *, causal=True, window=0, softcap=None,
                    q_chunk=1024, kv_chunk=1024):
    if _FORCE == "ref":
        return ref.flash_attention(q, k, v, causal, window, softcap,
                                   q_chunk, kv_chunk)
    if _FORCE == "cuda" and not q.is_cuda:
        raise RuntimeError("set_impl('cuda') needs CUDA tensors; q is on "
                           f"{q.device}")
    return fa.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap)


def decode_attention(q, k_cache, v_cache, cache_len, *, window=0,
                     softcap=None):
    return ref.decode_attention(q, k_cache, v_cache, cache_len,
                                window=window, softcap=softcap)
