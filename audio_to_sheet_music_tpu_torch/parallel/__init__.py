"""Several devices: the chunk-sharded sweep's mesh and data-parallel head
training (``mesh``), and their dry run on the CPU (``dryrun``)."""

from .mesh import (  # noqa: F401
    DATA_AXIS,
    Mesh,
    allreduce_mean_,
    init_data_parallel,
    make_mesh,
    pad_to_multiple,
    replicate,
    shard_batch,
)
