"""Crash-safe checkpoints: the port of the JAX package's
``checkpoint/checkpoint.py``, in its on-disk format, so either package
restores what the other wrote.

* **Logical layout**: one ``.npy`` file per leaf, named by its key path
  (``params.streams.0.attn.wq.npy``), the full logical tensor.
  ``manifest.json`` records each leaf's file, shape, dtype and CRC32 and
  the step; bfloat16 leaves are stored as a ``uint16`` view with
  ``"view": "bfloat16"``.  A ``ParamTree`` is walked like a dict (keys
  sorted), an ``nn.ModuleList`` like a tuple and a NamedTuple
  (``AdamWState``) by its fields, so ``{"params": p, "opt": state}`` has
  the JAX package's names.
* **Atomicity**: writes go to ``<dir>/tmp.<step>`` and are renamed to
  ``<dir>/step_<step>`` only after every file and the manifest are
  written (the manifest fsynced).  A crash mid-write never corrupts the
  latest valid checkpoint.
* **Integrity**: every leaf's CRC is checked on restore; a mismatch marks
  the checkpoint invalid and :func:`restore` falls back to the newest
  checkpoint whose manifest validates.
* **Sharded state**: a tree of DTensors is saved as its logical tensors
  (every rank gathers each leaf, rank 0 writes, all wait for it), and
  :func:`restore_resharded` places a checkpoint onto the placements of any
  mesh, whatever mesh wrote it.
"""

from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.models.transformer import ParamTree, tree_items


def _stored(leaf: torch.Tensor) -> tuple[np.ndarray, str, str]:
    """(the array written, the leaf's dtype name, the view) of a tensor
    (a DTensor's whole tensor)."""
    if hasattr(leaf, "full_tensor"):
        leaf = leaf.full_tensor()
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return (t.view(torch.int16).numpy().view(np.uint16), "bfloat16",
                "bfloat16")
    arr = t.numpy()
    return arr, str(arr.dtype), ""


def _flatten(tree) -> dict:
    """``{"/key/path": leaf}`` in the JAX package's leaf order."""
    return {"/" + "/".join(path): leaf for path, leaf in tree_items(tree)}


def _unflatten_into(template, flat: dict):
    """``template``'s structure with each leaf read from ``flat``, cast to
    the template leaf's dtype and placed on its device (the CPU for a meta
    template).  A ``ParamTree`` comes back as a new ``ParamTree``, each
    parameter's ``requires_grad`` as in the template."""
    def leaf(prefix, node):
        device = "cpu" if node.device.type == "meta" else node.device
        return flat[prefix].to(device=device, dtype=node.dtype)

    def walk(prefix, node, plain=False):
        if isinstance(node, ParamTree):
            d = {k: walk(f"{prefix}/{k}", node[k], True)
                 for k in node.keys()}
            if plain:
                return d
            out = ParamTree(d)
            for new, old in zip(out.parameters(), node.parameters()):
                new.requires_grad_(old.requires_grad)
            return out
        if isinstance(node, dict):
            return {k: walk(f"{prefix}/{k}", node[k]) for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*[walk(f"{prefix}/{k}", getattr(node, k))
                                for k in node._fields])
        if isinstance(node, (tuple, list, nn.ModuleList)):
            vals = [walk(f"{prefix}/{i}", v, plain)
                    for i, v in enumerate(node)]
            return vals if isinstance(node, list) else tuple(vals)
        return leaf(prefix, node)

    return walk("", template)


def save(ckpt_dir: str, step: int, tree: Any, metadata: Optional[dict] = None
         ) -> str:
    """Write ``tree`` as checkpoint ``step`` under ``ckpt_dir``; returns its
    directory.  A tree with DTensor leaves is a collective: every rank of
    the default process group calls it, rank 0 writes."""
    flat = _flatten(tree)
    # one leaf at a time, so at most one leaf is in host memory
    stored = ((name, _stored(node)) for name, node in flat.items())
    if not any(hasattr(v, "full_tensor") for v in flat.values()):
        return _write(ckpt_dir, step, stored, metadata)
    import torch.distributed as dist

    if dist.get_rank() == 0:
        final = _write(ckpt_dir, step, stored, metadata)
    else:
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        for _ in stored:      # the gathers, in step with rank 0's
            pass
    dist.barrier()
    return final


def _write(ckpt_dir: str, step: int, stored, metadata: Optional[dict]
           ) -> str:
    """Write the ``(name, _stored(leaf))`` pairs as checkpoint ``step``."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "metadata": metadata or {}, "arrays": {}}
    for name, (arr, dtype, view) in stored:
        fn = name.strip("/").replace("/", ".") + ".npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["arrays"][name] = {
            "file": fn, "shape": list(arr.shape), "dtype": dtype,
            "view": view,
            "crc": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _load_valid(path: str) -> Optional[dict]:
    """``{"/key/path": CPU tensor, "__step__": step}`` of a checkpoint
    whose every CRC matches, else None."""
    man_file = os.path.join(path, "manifest.json")
    if not os.path.exists(man_file):
        return None
    try:
        with open(man_file) as f:
            manifest = json.load(f)
        flat = {}
        for name, info in manifest["arrays"].items():
            arr = np.load(os.path.join(path, info["file"]))
            if zlib.crc32(np.ascontiguousarray(arr).tobytes()) != info["crc"]:
                return None
            if info.get("view") == "bfloat16":
                flat[name] = torch.from_numpy(
                    arr.view(np.int16)).view(torch.bfloat16)
            else:
                flat[name] = torch.from_numpy(arr)
        flat["__step__"] = manifest["step"]
        return flat
    except Exception:
        return None


def steps(ckpt_dir: str) -> list[int]:
    """The steps of the checkpoints under ``ckpt_dir``, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_"):
            out.append(int(d.split("_")[1]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    s = steps(ckpt_dir)
    return s[-1] if s else None


def restore(ckpt_dir: str, template: Any, step: Optional[int] = None):
    """Restore the requested (or newest *valid*) checkpoint into
    ``template``'s structure.  Returns (tree, step) or (None, None)."""
    cands = steps(ckpt_dir)
    if step is not None:
        cands = [s for s in cands if s == step]
    for s in reversed(cands):
        flat = _load_valid(os.path.join(ckpt_dir, f"step_{s:08d}"))
        if flat is not None:
            return _unflatten_into(template, flat), s
    return None, None


def restore_resharded(ckpt_dir: str, template: Any, shardings, mesh,
                      step: Optional[int] = None):
    """Elastic restore: :func:`restore`, then each logical tensor placed
    as a DTensor on ``mesh`` (any mesh: the one that saved the checkpoint
    or another) under ``shardings``, a tree of specs of ``template``'s
    structure (what ``launch.sharding``'s ``*_shardings`` give).  Returns
    (tree, step) or (None, None); a ``ParamTree`` comes back as a dict."""
    from repro_torch.launch.sharding import distribute_tree

    tree, s = restore(ckpt_dir, template, step)
    if tree is None:
        return None, None
    return distribute_tree(tree, shardings, mesh), s


def cleanup(ckpt_dir: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` checkpoints."""
    for s in steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
