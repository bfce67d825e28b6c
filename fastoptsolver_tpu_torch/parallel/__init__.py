"""Multi-device layer on ``torch.distributed`` (port of
``fastoptsolver_tpu.parallel``): meshes, sharded matvecs, the distributed
least-squares problem, instance sharding of a GramBatch and consensus ADMM.
``multihost`` holds the bootstrap and the host × chip mesh."""
from .mesh import (
    BATCH_AXIS,
    MODEL_AXIS,
    make_mesh,
    replicated,
    row_sharding,
    col_sharding,
    vec_sharding,
)
from .matvec import (
    row_sharded_matvec,
    row_sharded_rmatvec,
    row_sharded_normal_grad,
    row_sharded_value_and_grad,
    col_sharded_matvec,
    col_sharded_rmatvec,
    col_sharded_normal_grad,
)
from .admm import consensus_admm
from .problem import DistributedLeastSquares, shard_gram_batch

__all__ = [
    "BATCH_AXIS",
    "MODEL_AXIS",
    "make_mesh",
    "replicated",
    "row_sharding",
    "col_sharding",
    "vec_sharding",
    "row_sharded_matvec",
    "row_sharded_rmatvec",
    "row_sharded_normal_grad",
    "row_sharded_value_and_grad",
    "col_sharded_matvec",
    "col_sharded_rmatvec",
    "col_sharded_normal_grad",
    "DistributedLeastSquares",
    "shard_gram_batch",
    "consensus_admm",
]
