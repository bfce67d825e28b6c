"""Multi-host distribution: bootstrap, host × chip meshes and process-local
data assembly (port of ``fastoptsolver_tpu/parallel/multihost.py``).

The reference wires processes into one JAX runtime with
``jax.distributed.initialize``; here each rank is one process on one device
and :func:`initialize` joins it to a ``torch.distributed`` process group
(NCCL between CUDA devices, gloo on the CPU).

Layout rules, as the reference's:

- the **host axis** crosses hosts: put the low-traffic parallelism there
  (instance parallelism, whose only traffic is the gather of results, or
  consensus ADMM, one n-vector all-reduce an iteration);
- the **chip axis** stays within a host: put the per-iteration matvec
  all-reduces (``parallel/matvec.py``) there.

Ranks are numbered host-major, as ``torchrun`` numbers them: rank =
host · ranks-a-host + local rank, with ``LOCAL_WORLD_SIZE`` ranks a host.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor

from .mesh import default_backend, ensure_process_group, sharding

HOST_AXIS = "host"
CHIP_AXIS = "chip"

_ENV_COORD = "FASTOPT_COORDINATOR"
_ENV_NPROC = "FASTOPT_NUM_PROCESSES"
_ENV_PID = "FASTOPT_PROCESS_ID"


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               **kwargs) -> None:
    """Join this process to the process group (a repeat call does nothing).

    ``coordinator_address`` is ``host:port`` of rank 0's store. Arguments
    fall back to ``FASTOPT_COORDINATOR`` / ``FASTOPT_NUM_PROCESSES`` /
    ``FASTOPT_PROCESS_ID``, and from there to ``torchrun``'s
    ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``. A process that
    is part of no cluster (no argument, no variable) is left alone, so
    library code can call this unconditionally. ``backend`` defaults to
    NCCL where CUDA is available, gloo otherwise; ``kwargs`` go to
    ``dist.init_process_group``."""
    if dist.is_initialized():
        return
    coordinator_address = coordinator_address or os.environ.get(_ENV_COORD)
    if num_processes is None and _ENV_NPROC in os.environ:
        num_processes = int(os.environ[_ENV_NPROC])
    if process_id is None and _ENV_PID in os.environ:
        process_id = int(os.environ[_ENV_PID])
    if backend is None:
        backend = default_backend("cuda" if torch.cuda.is_available() else "cpu")
    if coordinator_address is None and num_processes is None:
        if "MASTER_ADDR" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://", **kwargs)
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a coordinator address, the number of processes and this "
                         "process's id are all needed to join a group")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, **kwargs)


def make_host_chip_mesh(hosts: int | None = None, chips_per_host: int | None = None,
                        device_type: str | None = None, host_axis: str = HOST_AXIS,
                        chip_axis: str = CHIP_AXIS) -> DeviceMesh:
    """A ``(host, chip)`` mesh whose leading axis crosses hosts and whose
    trailing axis stays within one. With ``LOCAL_WORLD_SIZE`` set (torchrun
    sets it) each mesh row is exactly one host's ranks, and a requested
    shape must match that topology; without it the ranks split into
    ``hosts`` equal groups, so the same two-axis programs run on one host."""
    device_type = device_type or "cuda"
    ensure_process_group(device_type)
    n = dist.get_world_size()
    if "LOCAL_WORLD_SIZE" in os.environ and n > 1:
        local = int(os.environ["LOCAL_WORLD_SIZE"])
        if local < 1 or n % local:
            raise ValueError(f"uneven ranks per host: {n} ranks, {local} a host")
        n_hosts = n // local
        hosts = n_hosts if hosts is None else hosts
        chips_per_host = local if chips_per_host is None else chips_per_host
        if hosts != n_hosts or chips_per_host != local:
            raise ValueError(f"requested {hosts}x{chips_per_host} mesh but topology is "
                             f"{n_hosts} hosts x {local} ranks")
    else:
        if hosts is None:
            hosts = 1 if chips_per_host is None else n // chips_per_host
        if chips_per_host is None:
            chips_per_host = n // hosts
        if hosts * chips_per_host != n:
            raise ValueError(f"mesh {hosts}x{chips_per_host} != {n} devices")
    return init_device_mesh(device_type, (hosts, chips_per_host),
                            mesh_dim_names=(host_axis, chip_axis))


def host_sharded(mesh: DeviceMesh, axis: str = HOST_AXIS):
    """Leading-dimension sharding over the host axis."""
    return sharding(mesh, axis, 0)


def from_process_local(local_data, mesh: DeviceMesh, placements) -> DTensor:
    """The global ``DTensor`` of which ``local_data`` is this rank's block:
    no rank ever holds the global array, each contributes the rows or
    instances it made or loaded (ranks of one host along a replicated axis
    pass the same block). NumPy goes to the mesh's device type."""
    t = (local_data if isinstance(local_data, torch.Tensor)
         else torch.as_tensor(np.asarray(local_data), device=mesh.device_type))
    return DTensor.from_local(t.contiguous(), mesh, placements, run_check=False)


def gram_batch_from_local(local_gb, mesh: DeviceMesh, axis: str = HOST_AXIS):
    """A GramBatch sharded on its instance axis over ``axis`` from each
    rank's own instances (the Gram form of its local data, built with
    ``batch.make_gram_batch``)."""
    from ..batch.fista_gram import GramBatch

    lay = lambda t: from_process_local(t, mesh, sharding(mesh, axis, t.dim() - 1))
    return GramBatch(Q=lay(local_gb.Q), c=lay(local_gb.c), btb=lay(local_gb.btb),
                     alpha1=lay(local_gb.alpha1), alpha2=lay(local_gb.alpha2),
                     L=lay(local_gb.L))


def allgather(x) -> np.ndarray:
    """A global array as NumPy on every rank: a ``DTensor``'s full value, or
    each rank's tensor concatenated along its leading axis in rank order
    (the reference's ``process_allgather(tiled=True)``)."""
    if isinstance(x, DTensor):
        return x.full_tensor().cpu().numpy()
    t = torch.as_tensor(x).contiguous()
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return t.cpu().numpy()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.cat([p.reshape((-1,) + tuple(t.shape[1:])) for p in parts]).cpu().numpy()
