"""Scale-out over cards and hosts (counterpart of seqlib_tpu/parallel):
``mesh`` (data parallelism over the cards of one host), ``multihost``
(processes joined by ``torch.distributed``), ``scaling`` (reads/s over
mesh sizes) and ``dryrun`` (the multi-device parity checks)."""

from .mesh import (Mesh, make_mesh, shard_batch, sharded_extend_step,
                   sharded_seed_step)

__all__ = ["make_mesh", "shard_batch", "sharded_extend_step",
           "sharded_seed_step"]
