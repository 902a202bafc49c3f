"""Public kernel API with implementation dispatch (the port of the JAX
package's ``kernels/ops.py``: its attention and RWKV6 entry points).

Models call these wrappers.  ``set_impl`` forces a path:

  set_impl("ref")     always the plain PyTorch twin (``kernels/ref.py``)
  set_impl("cuda")    always the CUDA kernel; a CPU tensor raises
  set_impl(None)      by the tensor (default): a CUDA tensor launches the
                      kernel, a CPU tensor takes the plain twin

``decode_attention`` and ``rwkv6_decode`` have no kernel in either package:
they are the plain ops.  The JAX ``rwkv6`` reads its chunk from the
environment (``REPRO_RWKV_CHUNK``); the chunk does not change the result
(both chunked forms run the same sequential steps), so here it is an
argument and no environment variable is read.
"""

from __future__ import annotations

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv6_scan as rk

IMPLS = (None, "ref", "cuda")
_FORCE = None


def _cuda_forced(x, name: str) -> None:
    if _FORCE == "cuda" and not x.is_cuda:
        raise RuntimeError(f"set_impl('cuda') needs CUDA tensors; {name} is "
                           f"on {x.device}")


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
    _cuda_forced(q, "q")
    return fa.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap)


def decode_attention(q, k_cache, v_cache, cache_len, *, window=0,
                     softcap=None):
    return ref.decode_attention(q, k_cache, v_cache, cache_len,
                                window=window, softcap=softcap)


def rwkv6(r, k, v, w, u, state, *, chunk=64):
    if _FORCE == "ref":
        return rk.plain(r, k, v, w, u, state, chunk)
    _cuda_forced(r, "r")
    return rk.rwkv6(r, k, v, w, u, state, chunk=chunk)


def rwkv6_decode(r, k, v, w, u, state):
    return ref.rwkv6_decode(r, k, v, w, u, state)
