"""Instance parallelism over a mesh axis: each rank solves whole instances
(lanes), so the only communication is the layout going in and the gather of
the per-lane results coming out.

The batch is zero-padded to a multiple of a padding quantum times the axis
size, and rank r takes the r-th contiguous block of lanes, as the
reference's ``device_put`` onto ``P(..., axis)`` lays a padded batch out.
The results are gathered to every rank as plain tensors (what a JAX caller
reads from the global array); a DTensor could not hold the padded layout,
where the last ranks may hold no real lane, without a reshuffle, and the
per-lane outputs are small beside A.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from .mesh import axis_size, sharding


class LaneLayout:
    """Rank ``rank``'s block ``[lo, lo + per_rank)`` of ``B`` lanes padded
    to ``padded`` = a multiple of ``quantum · size``."""

    def __init__(self, mesh: DeviceMesh, axis: str, B: int, quantum: int):
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a torch.distributed DeviceMesh, got "
                            f"{type(mesh).__name__}")
        self.mesh, self.axis, self.B = mesh, axis, B
        self.size = axis_size(mesh, axis)
        self.group = mesh.get_group(axis)
        self.step = step = quantum * self.size
        self.padded = -(-B // step) * step
        self.per_rank = self.padded // self.size
        self.lo = mesh.get_local_rank(axis) * self.per_rank

    def take(self, t, dim: int = -1, fill=0):
        """This rank's lanes of ``t`` along ``dim``, filled with ``fill``
        past the batch; ``t`` is the whole batch every rank holds, or a
        DTensor already sharded on ``dim`` over the axis, and replicated
        over every other, whose blocks are this layout's."""
        if isinstance(t, DTensor):
            want = sharding(self.mesh, self.axis, dim % t.dim())
            if (t.device_mesh != self.mesh or list(t.placements) != want
                    or self.padded != self.B):
                raise ValueError(
                    f"a DTensor input must be sharded on its instance axis over "
                    f"'{self.axis}' of this mesh and replicated over its other axes, "
                    f"its {self.B} lanes a multiple of {self.step} (a DTensor holds "
                    f"no padding)")
            return t.to_local()
        if not isinstance(t, torch.Tensor):
            t = torch.as_tensor(t)
        d = dim % t.dim()
        hi = min(self.lo + self.per_rank, self.B)
        blk = t.narrow(d, min(self.lo, self.B), max(hi - self.lo, 0))
        short = self.per_rank - blk.shape[d]
        if short:
            shape = list(blk.shape)
            shape[d] = short
            blk = torch.cat([blk, torch.full(shape, fill, dtype=t.dtype, device=t.device)], d)
        return blk.contiguous()

    def take_vector(self, v, like: torch.Tensor) -> torch.Tensor:
        """This rank's lanes of a per-lane vector (or a scalar for every
        lane), in ``like``'s dtype and device."""
        if isinstance(v, DTensor):
            return self.take(v).to(like.dtype)
        v = torch.as_tensor(v, dtype=like.dtype, device=like.device)
        return self.take(v.broadcast_to((self.B,)))

    def gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's lanes of ``t`` along ``dim``, in rank order, on every
        rank, cut back to the batch (``all_gather``, the list form)."""
        d = dim % t.dim()
        wire = t.to(torch.uint8) if t.dtype == torch.bool else t
        parts = [torch.empty_like(wire) for _ in range(self.size)]
        dist.all_gather(parts, wire.contiguous(), group=self.group)
        out = torch.cat(parts, d).narrow(d, 0, self.B)
        return out.to(torch.bool) if t.dtype == torch.bool else out
