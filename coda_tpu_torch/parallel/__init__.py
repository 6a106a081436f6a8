from coda_tpu_torch.parallel.collectives import (
    broadcast_from_owner,
    gather_sum,
)
from coda_tpu_torch.parallel.distributed import initialize, is_primary
from coda_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    make_mesh,
    mesh_from_spec,
    replicated,
    shard_preds,
)

__all__ = [
    "MODEL_AXIS",
    "DATA_AXIS",
    "Mesh",
    "make_mesh",
    "mesh_from_spec",
    "shard_preds",
    "replicated",
    "initialize",
    "is_primary",
    "gather_sum",
    "broadcast_from_owner",
]
