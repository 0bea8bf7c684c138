"""The distributed tier: the process-group mesh and the sharded sparse
pull/push over it.

Port of the JAX package's ``parallel`` package: a
``torch.distributed`` process group (one rank a card) and its
``all_to_all`` / ``all_reduce`` / ``all_gather`` stand in for the JAX
mesh's XLA collectives; the pass table is sharded over the ranks. The host
plane over several hosts is ``transport`` (``TcpTransport``,
``TcpShuffleRouter``) and ``membership`` (``OwnershipMap``). The pipeline
and ring attention modules are not ported.
"""

from paddlebox_tpu_torch.parallel.mesh import (
    MeshPlan,
    axis_size,
    destroy_mesh,
    local_slice,
    make_mesh,
    put_axis1_blocks,
    put_per_device_copies,
    put_replicated,
    put_sharded,
)
from paddlebox_tpu_torch.parallel.sharded_pullpush import sharded_pull, sharded_push, sharded_serve_pull

__all__ = [
    "MeshPlan",
    "axis_size",
    "destroy_mesh",
    "local_slice",
    "make_mesh",
    "put_axis1_blocks",
    "put_per_device_copies",
    "put_replicated",
    "put_sharded",
    "sharded_pull",
    "sharded_push",
    "sharded_serve_pull",
]
