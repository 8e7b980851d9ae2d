"""Data parallelism over ranks: the port of :mod:`spoofsv_tpu.parallel`.

:mod:`~spoofsv_torch.parallel.mesh` holds the mesh (one process per device,
the batch split by rows, collectives on ``torch.distributed``);
:mod:`~spoofsv_torch.parallel.multihost` joins or spawns a process group;
:mod:`~spoofsv_torch.parallel.dryrun` runs one data-parallel adversarial
step and one sharded synthesis call at the reference's widths.
"""

from spoofsv_torch.parallel.mesh import (LocalRows, Mesh, all_reduce_grads, batch_sharding,
                                         make_mesh, replicate_tree, replicated, shard_batch)

__all__ = ["LocalRows", "Mesh", "all_reduce_grads", "batch_sharding", "make_mesh",
           "replicate_tree", "replicated", "shard_batch"]
