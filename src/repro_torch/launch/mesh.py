"""Device meshes of the port: ``torch.distributed`` ``DeviceMesh``es with
the reference's axis names, in the reference's order.

A copy of the JAX package's ``launch/mesh.py``. Functions, never
module-level constants: importing this module creates no process group.
A mesh needs one: ``torch.distributed.init_process_group`` with the rank
and world size given (``tcp://localhost:<port>`` or a ``FileStore``), a
``"gloo"`` group on the CPU, ``"nccl"`` on cards, or the dry run's fake
group of 256 or 512 ranks (``launch/dryrun.py``). The reference's
``jax_compat`` (shims over JAX versions, ``AxisType`` among them) has no
counterpart: the port has no JAX.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from repro_torch.models import partitioning as part


def default_device_type() -> str:
    """The device type of the mesh's ranks: ``"cuda"`` under an NCCL group,
    else ``"cpu"``."""
    dist = torch.distributed
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return "cuda"
    return "cpu"


def make_mesh(shape, axes, device_type: Optional[str] = None):
    """``init_device_mesh`` over the ranks of the default process group."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type or default_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


@contextlib.contextmanager
def set_mesh(mesh):
    """Make ``mesh`` ambient for the activation constraints of
    ``models/partitioning.py`` and the expert-parallel MoE, as
    ``jax.set_mesh``."""
    prev = part._swap_mesh(mesh)
    try:
        yield mesh
    finally:
        part._swap_mesh(prev)


def compute_mesh(mesh):
    """The mesh the steps run on: ``mesh`` itself, or for a pod mesh
    ("pod", "data", "model") its 2-D view ("pod_data", "model"), pod-major,
    which keeps the pod mesh's axis sizes (``partitioning.FLAT``). Specs
    name the same shards on both; the 2-D view keeps DTensor's sharding
    propagation to two mesh dims."""
    names = tuple(mesh.mesh_dim_names)
    if names[:2] != part.FLAT_AXES:
        return mesh
    sizes = part.mesh_sizes(mesh)
    mesh[part.FLAT_AXES]._flatten(part.FLAT)
    view = mesh[(part.FLAT,) + names[2:]]
    view.trims_axes = sizes
    return view


def make_production_mesh(*, multi_pod: bool = False, device_type: Optional[str] = None):
    """16x16 = 256 ranks per pod; multi-pod adds a leading pod=2 axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_local_mesh(data: int = 1, model: int = 1, device_type: Optional[str] = None):
    """Small mesh over the ranks of the process group, clamped as the
    reference clamps to the devices it has."""
    n = torch.distributed.get_world_size()
    data = min(data, n)
    model = max(1, min(model, n // data))
    if data * model != n:
        raise ValueError(f"mesh ({data}, {model}) does not cover the {n} ranks")
    return make_mesh((data, model), ("data", "model"), device_type)


def batch_axes(mesh) -> Tuple[str, ...]:
    """Axes the global batch is sharded over."""
    names = part.mesh_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def model_axis(mesh) -> Optional[str]:
    return "model" if "model" in part.mesh_sizes(mesh) else None


def n_chips(mesh) -> int:
    n = 1
    for s in part.mesh_sizes(mesh).values():
        n *= s
    return n


def act_axes(mesh):
    """The ``(batch, model)`` pair that ``activation_axes`` takes for
    ``mesh``: one batch axis as its name, several as a tuple."""
    ba = batch_axes(mesh)
    return (ba if len(ba) > 1 else (ba[0] if ba else None)), model_axis(mesh)
