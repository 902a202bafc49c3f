"""Device meshes: the port of the JAX package's ``launch/mesh.py`` over
``torch.distributed.device_mesh``.

The meshes have the JAX package's shapes and axis names: ``("data",
"model")``, or ``("pod", "data", "model")`` with two pods.  Building one
needs a process group of exactly the mesh's size, set up by the caller
(``torch.distributed.init_process_group``); a world of another size is an
error that names the size the mesh needs, never a smaller mesh.  The
device is the CUDA device unless the caller passes ``device="cpu"``.

``dp_axes``, ``tp_size`` and ``dp_size`` read a ``DeviceMesh`` or a plain
mesh description (``dp_index``, this rank's data shard, a ``DeviceMesh``): any object with ``axis_names`` and a ``shape`` mapping
from axis name to size, on which the sharding rules run for the
production shapes without devices.
"""

from __future__ import annotations

import math

from repro_torch.core.scheduler import resolve_device


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` in mesh order, of a ``DeviceMesh`` or a mesh
    description."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                              # a DeviceMesh
        return dict(zip(names, mesh.shape))
    return {a: mesh.shape[a] for a in mesh.axis_names}


def _build(shape: tuple, axes: tuple, device):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    need = math.prod(shape)
    layout = " x ".join(f"{a}={n}" for a, n in zip(axes, shape))
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(f"the mesh {layout} needs a process group of "
                           f"{need} ranks; none is initialized")
    world = dist.get_world_size()
    if world != need:
        raise RuntimeError(f"the mesh {layout} needs {need} ranks; the "
                           f"process group has {world}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """(16, 16) ``("data", "model")``, or (2, 16, 16) with ``"pod"``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _build(shape, axes, device)


def make_test_mesh(n_data: int = 2, n_model: int = 2, *, multi_pod=False,
                   device=None):
    """A small mesh: (n_data, n_model), or (2, n_data, n_model) with
    ``"pod"``."""
    if multi_pod:
        return _build((2, n_data, n_model), ("pod", "data", "model"), device)
    return _build((n_data, n_model), ("data", "model"), device)


def dp_axes(mesh) -> tuple:
    """Axes that carry data parallelism (pod included when present)."""
    return tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))


def tp_size(mesh) -> int:
    return axis_sizes(mesh)["model"]


def dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in dp_axes(mesh))


def dp_index(mesh) -> int:
    """This rank's data shard on the ``DeviceMesh`` ``mesh``: the row-major
    index of its coordinate over :func:`dp_axes` (pod-major), the order in
    which a batch split over those axes lays out its rows."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = axis_sizes(mesh)
    shard = 0
    for a in dp_axes(mesh):
        shard = shard * sizes[a] + coord[a]
    return shard
