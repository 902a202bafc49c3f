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
    """(the array written, the leaf's dtype name, the view) of a tensor."""
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
    directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "metadata": metadata or {}, "arrays": {}}
    for name, node in _flatten(tree).items():
        fn = name.strip("/").replace("/", ".") + ".npy"
        stored, dtype, view = _stored(node)
        np.save(os.path.join(tmp, fn), stored)
        manifest["arrays"][name] = {
            "file": fn, "shape": list(stored.shape), "dtype": dtype,
            "view": view,
            "crc": zlib.crc32(np.ascontiguousarray(stored).tobytes()),
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


def cleanup(ckpt_dir: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` checkpoints."""
    for s in steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
