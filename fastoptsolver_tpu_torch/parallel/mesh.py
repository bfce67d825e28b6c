"""Device meshes on ``torch.distributed`` (port of
``fastoptsolver_tpu/parallel/mesh.py``).

Two named axes, as in the reference:

- ``"batch"``: instance parallelism, independent problem instances split
  across ranks (no communication but the gather of the results);
- ``"model"``: problem parallelism, one design matrix row- or
  column-sharded across ranks, with all-reduced matvecs
  (``parallel/matvec.py``).

The reference's mesh is single-controller: one process holds global arrays
and ``shard_map`` runs a local function per device. PyTorch's idiom is SPMD:
one process per device (a *rank*), a ``DeviceMesh`` naming the axes over the
process group, and ``DTensor`` for the global view. Every entry point here
is called by every rank of the mesh, with the same arguments; each
``psum`` of the reference is one ``dist.all_reduce`` on the axis's group.

``make_mesh`` is the one place the topology enters. A process that joined
no group (``parallel.multihost.initialize`` joins one) gets a one-rank group
of its own, so that a one-device mesh works as JAX's does. The placements
below stand for the reference's ``PartitionSpec``s: one entry per mesh
axis, ``Shard(d)`` on the named axis and ``Replicate()`` on the others.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

BATCH_AXIS = "batch"
MODEL_AXIS = "model"


def default_backend(device_type: str) -> str:
    """NCCL for ranks on CUDA devices, gloo on the CPU."""
    return "nccl" if device_type == "cuda" else "gloo"


def ensure_process_group(device_type: str = "cuda") -> None:
    """Give a process that joined no group a one-rank group of its own (an
    in-process store, no port)."""
    if not dist.is_initialized():
        backend = default_backend(device_type)
        dev = (torch.device("cuda", torch.cuda.current_device()) if backend == "nccl"
               else None)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                device_id=dev)


def make_mesh(batch: int | None = None, model: int | None = None,
              device_type: str | None = None) -> DeviceMesh:
    """A ``(batch × model)`` mesh over every rank of the process group. With
    only one size given, the other takes the remaining ranks; with neither,
    every rank goes to ``batch``. ``device_type`` is ``"cuda"`` unless the
    caller asks for ``"cpu"``."""
    device_type = device_type or "cuda"
    ensure_process_group(device_type)
    n = dist.get_world_size()
    if batch is None and model is None:
        batch, model = n, 1
    elif batch is None:
        batch = n // model
    elif model is None:
        model = n // batch
    if batch * model != n:
        raise ValueError(f"mesh {batch}x{model} != {n} devices")
    return init_device_mesh(device_type, (batch, model),
                            mesh_dim_names=(BATCH_AXIS, MODEL_AXIS))


def _spec(mesh: DeviceMesh, axis: str | None, dim: int):
    names = mesh.mesh_dim_names
    if axis is not None and axis not in names:
        raise ValueError(f"mesh has no axis {axis!r} (axes {names})")
    return [Shard(dim) if name == axis else Replicate() for name in names]


def replicated(mesh: DeviceMesh):
    return _spec(mesh, None, 0)


def row_sharding(mesh: DeviceMesh, axis: str = MODEL_AXIS):
    """(m, n) matrix sharded along rows."""
    return _spec(mesh, axis, 0)


def col_sharding(mesh: DeviceMesh, axis: str = MODEL_AXIS):
    """(m, n) matrix sharded along columns."""
    return _spec(mesh, axis, 1)


def vec_sharding(mesh: DeviceMesh, axis: str = MODEL_AXIS):
    return _spec(mesh, axis, 0)


def sharding(mesh: DeviceMesh, axis: str, dim: int):
    """Dimension ``dim`` sharded over ``axis`` (the reference's
    ``P(None, ..., axis)`` for the trailing instance axis of a batch)."""
    return _spec(mesh, axis, dim)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def local(t):
    """This rank's block of a ``DTensor``; any other tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def place(t, mesh: DeviceMesh, placements) -> DTensor:
    """``t`` laid out as ``placements`` on ``mesh``, as ``jax.device_put``
    lays out a global array: a ``DTensor`` is redistributed, any other
    tensor is the global value held by every rank, of which each keeps its
    block (no communication). Sharded dimensions must split evenly."""
    if isinstance(t, DTensor):
        if tuple(t.placements) == tuple(placements):
            return t
        return t.redistribute(mesh, placements)
    for p, size in zip(placements, mesh.shape):
        if isinstance(p, Shard) and t.shape[p.dim] % size:
            raise ValueError(f"dimension {p.dim} of size {t.shape[p.dim]} does not "
                             f"split evenly over a mesh axis of {size}")
    return distribute_tensor(t, mesh, placements, src_data_rank=None)
